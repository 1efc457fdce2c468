#!/usr/bin/env python3
"""A/B of the port's kernel wrappers against another tree's, in one
process on one CUDA card.

    python3 scripts/kernel_ab.py OTHER [MORE ...] [--rounds N] [--sets NAME ...]

OTHER is the root of another checkout of this repo, for example the
parent commit unpacked into the git-ignored ``_checkout/``::

    mkdir -p _checkout/parent && git archive HEAD~1 | tar -x -C _checkout/parent
    python3 scripts/kernel_ab.py _checkout/parent

Its ``alacnet_tpu_torch`` is imported under another name beside
this tree's, so both trees' real wrappers (each builds its own tree's
kernels) run on the same inputs: the main paths' calls, recorded on the
card as ``chip_smoke.py`` records them.

- ``blob_words``, ``pack_rows``, ``rice_lpc``, ``bulk_bits``,
  ``dec_epilogue``: every call of one pooled ``decode_streams`` of the
  smoke corpus, each file 96 times; a tree without the ``blob_words``
  kernel runs ``blob_words_plain``, the chain of torch ops its
  ``blob_words`` runs;
- ``rice_lpc_session``: every ``rice_lpc`` call of one
  ``AlacContext.read_all`` of ``chip_smoke.py``'s long stream (a pass
  per 64-frame window);
- ``enc_pred``, ``enc_rice``, ``rice_emit``: every
  ``predictor_errors_fused`` and ``rice_merge_fused`` call of one pooled
  ``encode_files(device="cuda")`` of the decoded smoke corpus
  (``chip_smoke.py`` phase 4's recording: 12 calls of up to 2048 lanes);
  ``rice_emit`` runs the ``rice_merge_fused`` calls' arguments through
  ``rice_symbols_fused`` (``chip_smoke.py`` phase 6);
- ``enc_prologue``: every ``encode_prologue_fused`` call of that pooled
  encode; a tree without the kernel runs ``encode_prologue_plain`` and
  the transposing copy to the (S, 2F) layout, the chain its
  ``encode_stages_pcm`` and ``predictor_errors_fused`` run;
- ``zero_runs``, ``pair_merge``: every ``zero_run_lengths_fused`` and
  ``merge_pair_chunks_fused`` call of that pooled encode; a tree without
  the ``pair_merge`` kernel runs its plain ``merge_pair_chunks`` (then
  ``merge_quad_chunks`` for a quad call), as its ``encode_stages`` does;
  ``zero_runs`` also runs this tree's kernel at each strip width of
  ``ops/cuda/zero_runs.STRIPS`` (``port_strip<N>``) beside the one
  ``pick_strip`` chooses;
- ``encode_e2e``: that pooled ``encode_files`` through each tree's
  package in turns (this tree, then OTHER and every MORE tree, then
  back in reverse order, per round), timing the wall, the host prep
  (``encoder_device._prep``) and the dispatch (``_dispatch``) apart,
  and then each tree's device-busy time in one more run under
  ``torch.profiler``.  Every tree's output bytes must be equal.

Every output of the other tree must equal this tree's, bit for bit.  Per round, each wrapper (and for ``pack_rows``
``torch.take`` of the same rows) runs every call of a set, in turns, the
order reversed every other round.  Each figure is the median over
``--rounds`` rounds of a sum over the set's calls of:

- ``ms``: 5 calls from the host, CUDA events around them (the wrapper's
  host work counts where it outlasts the kernel);
- ``host_us``: the host's time per call in those 5 calls, before the
  wait for the card;
- ``device_ms`` (``chip_smoke.DEVICE_TIMED``, also per call as
  ``device_ms_per_call``): a CUDA graph of 5 calls
  replayed, the card alone (``chip_smoke.graph_replay_ms``).

Prints one JSON line per set and the card's name and power limit, and
writes them to ``chiprun_out/kernel_ab.json``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import io
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: The name the other tree's package is imported under (the MORE trees
#: add 2, 3, ...).
OTHER = "other_alacnet_tpu_torch"


def load_package(root: pathlib.Path, name: str):
    """The ``alacnet_tpu_torch`` under ``root``, imported as ``name``
    (the package imports itself relatively)."""
    pkg = root / "alacnet_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def wrappers(name: str) -> dict:
    """{kernel: wrapper} of the package imported as ``name``."""
    def sub(path):
        return importlib.import_module(f"{name}.{path}")

    enc = sub("ops.cuda.enc_stages")
    try:
        pair_merge = sub("ops.cuda.pair_merge").merge_pair_chunks_fused
    except ImportError:  # a tree whose encode_stages runs the plain merge
        plain = sub("ops.encode")

        def pair_merge(c0, c1, c2, ws, quads=False, kernel="auto"):
            pairs = plain.merge_pair_chunks(c0, c1, c2, ws)
            return (*pairs, *plain.merge_quad_chunks(*pairs[:4])) if quads else pairs
    pack_rows = sub("ops.cuda.pack_rows")
    try:
        prologue = sub("ops.cuda.enc_prologue").encode_prologue_fused
    except ImportError:  # a tree whose encode_stages_pcm runs the chain
        from alacnet_tpu_torch.ops.cuda.enc_prologue import encode_prologue_plain

        def prologue(pcm, stereo, lw=0, sh=0, ub8=0, wide=False, kernel="auto"):
            return encode_prologue_plain(pcm, stereo, lw, sh, ub8, wide).t().contiguous()
    if hasattr(pack_rows, "blob_words_fused"):
        blob = pack_rows.blob_words_fused
    else:  # a tree whose blob_words runs the chain
        from alacnet_tpu_torch.ops.cuda.pack_rows import blob_words_plain

        def blob(x, tail_be, nq, kernel="auto"):
            return blob_words_plain(x, tail_be, nq)
    return {"blob_words": blob, "pack_rows": pack_rows.pack_rows,
            "dec_epilogue": sub("ops.cuda.epilogue").decode_epilogue,
            "enc_prologue": prologue,
            "rice_lpc": sub("ops.cuda.rice_lpc").fused_rice_lpc,
            "bulk_bits": sub("ops.cuda.bulk_bits").bulk_bits,
            "enc_pred": enc.predictor_errors_fused, "enc_rice": enc.rice_merge_fused,
            "rice_emit": sub("ops.cuda.rice_emit").rice_symbols_fused,
            "zero_runs": sub("ops.cuda.zero_runs").zero_run_lengths_fused,
            "pair_merge": pair_merge}


def strip_runs(calls) -> dict:
    """This tree's ``zero_runs`` calls at each strip width, forced."""
    from alacnet_tpu_torch.ops.cuda import zero_runs

    def run(a, kw, strip):
        saved = zero_runs.pick_strip
        zero_runs.pick_strip = lambda B, sms: strip
        try:
            return zero_runs.zero_run_lengths_fused(*a, **{**kw, "kernel": "cuda"})
        finally:
            zero_runs.pick_strip = saved

    return {f"port_strip{strip}": [lambda a=a, kw=kw, s=strip: run(a, kw, s) for a, kw in calls]
            for strip in zero_runs.STRIPS}


def lanes(kernel: str, args) -> int:
    """The lanes (or frames, or words) of a recorded call."""
    if kernel == "pack_rows":
        return args[1].shape[0]
    if kernel == "zero_runs":
        return args[0].shape[-1]
    if kernel == "dec_epilogue":
        return args[12].shape[0]
    return args[0].shape[0]


def timed(run, reps: int = 5) -> tuple[float, float]:
    """(ms per call from the host with CUDA events, host us per call)."""
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    host = time.perf_counter() - t0
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, host / reps * 1e6


def same(a, b) -> bool:
    import torch

    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def encode_turn(pkg_name: str, decoded, names) -> tuple[dict, list[bytes]]:
    """One pooled ``encode_files(device="cuda")`` (``chip_smoke.py``
    phase 5's) through the package imported as ``pkg_name``: the wall,
    the rate, the host prep and the dispatch timed apart, and the
    pipeline's own ``timings``; and the output bytes."""
    import torch

    import chip_smoke as cs

    pkg = importlib.import_module(pkg_name)
    mod = importlib.import_module(f"{pkg_name}.codec.encoder_device")
    spent = {"host_prep_s": 0.0, "dispatch_s": 0.0}
    timings: dict = {}
    saved = {k: getattr(mod, k) for k in ("_prep", "_dispatch", "encode_frames_device")}

    def clocked(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    mod._prep = clocked("host_prep_s", saved["_prep"])
    mod._dispatch = clocked("dispatch_s", saved["_dispatch"])
    mod.encode_frames_device = lambda *a, **kw: saved["encode_frames_device"](
        *a, **{**kw, "timings": timings})
    files = [decoded[n] for n in names for _ in range(cs.COPIES)]
    outs = [io.BytesIO() for _ in files]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pkg.encode_files([r.pcm for r in files], outs, [r.sample_rate for r in files],
                         [r.bits_per_sample for r in files], config=pkg.EncoderConfig(),
                         device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)
    samples = sum(r.pcm.shape[0] for r in files)
    return ({"wall_s": wall, "msamples_per_s": samples / wall / 1e6, **spent,
             "timings": timings}, [o.getvalue() for o in outs])


def encode_e2e(trees: dict, decoded, names, rounds: int, smi: str) -> dict:
    """The ``encode_e2e`` set: {tree label: package name} in turns."""
    from alacnet_tpu_torch.utils.observability import profile_busy

    order = list(trees)
    runs = {t: [] for t in order}
    # A warm-up run per tree (it builds that tree's kernels and native
    # tier), whose bytes every run must equal.
    outs = [encode_turn(trees[t], decoded, names)[1] for t in order]
    exact = all(o == outs[0] for o in outs)
    for _ in range(rounds):
        for tree in order + order[::-1]:
            res, datas = encode_turn(trees[tree], decoded, names)
            runs[tree].append(res)
            exact = exact and datas == outs[0]
    busy = {}
    for tree in order:
        b = profile_busy(lambda: encode_turn(trees[tree], decoded, names))
        busy[tree] = {k: b[k] for k in ("profiled_wall_s", "device_busy_ms",
                                         "device_busy_share")}
    med = {key: {t: statistics.median(r[key] for r in runs[t]) for t in order}
           for key in ("wall_s", "msamples_per_s", "host_prep_s", "dispatch_s")}
    spread = {t: [min(r["msamples_per_s"] for r in runs[t]),
                  max(r["msamples_per_s"] for r in runs[t])] for t in order}
    return {"set": "encode_e2e", "trees": trees, "runs_per_tree": 2 * rounds,
            "exact": exact, **med, "msamples_per_s_range": spread, "busy": busy,
            "card": smi, "rounds": runs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=pathlib.Path, help="root of the other checkout")
    ap.add_argument("more", type=pathlib.Path, nargs="*",
                    help="roots of more checkouts, for the encode_e2e set only")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--sets", nargs="*", default=None,
                    help="the sets to run (default: all)")
    opt = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import alacnet_tpu_torch
    import chip_smoke as cs

    smi = cs.nvidia_smi()
    port = {**cs.decode_fns(), **cs.enc_fns()}
    load_package(opt.other.resolve(), OTHER)
    other = wrappers(OTHER)
    trees = {"port": "alacnet_tpu_torch", "other": OTHER}
    for i, root in enumerate(opt.more):
        trees[f"more{i + 1}"] = f"{OTHER}{i + 2}"
        load_package(root.resolve(), trees[f"more{i + 1}"])
    dec_sets = ("blob_words", "pack_rows", "rice_lpc", "bulk_bits", "dec_epilogue")
    enc_sets = {"enc_prologue", "enc_pred", "enc_rice", "rice_emit", "zero_runs",
                "pair_merge"}
    wanted = set(opt.sets or (*dec_sets, "rice_lpc_session", *enc_sets, "encode_e2e"))

    names, data, _ = cs.load_corpus()
    sets = {}
    if wanted & set(dec_sets):
        pooled, _ = cs.record_calls(names, data, alacnet_tpu_torch.DecodeConfig(device="cuda"))
        sets.update({k: (k, pooled[k]) for k in dec_sets})
    if "rice_lpc_session" in wanted:
        music = alacnet_tpu_torch.decode_file(cs.CORPUS / "music.m4a", device="cuda")
        sets["rice_lpc_session"] = ("rice_lpc", cs.record_session_calls(cs.long_stream(music)[1]))
    decoded = None
    if wanted & (enc_sets | {"encode_e2e"}):
        decoded = dict(zip(names, alacnet_tpu_torch.decode_streams(
            [io.BytesIO(data[n]) for n in names], device="cuda")))
    if wanted & enc_sets:
        enc_calls, _, _ = cs.record_enc_calls(decoded, names)
        sets.update({k: (k, enc_calls[k]) for k in ("enc_prologue", "enc_pred", "enc_rice",
                                                     "zero_runs", "pair_merge")})
        sets["rice_emit"] = ("rice_emit", enc_calls["enc_rice"])
    sets = {k: v for k, v in sets.items() if k in wanted}

    results = []
    for set_name, (kernel, calls) in sets.items():
        runs = {tree: [lambda a=a, kw=kw, f=fns[kernel]: f(*a, **{**kw, "kernel": "cuda"})
                       for a, kw in calls]
                for tree, fns in (("port", port), ("other", other))}
        if kernel == "zero_runs":
            runs.update(strip_runs(calls))
        exact = all(same(r(), ref()) for name, rs in runs.items() if name != "port"
                    for r, ref in zip(rs, runs["port"]))
        if kernel == "pack_rows":
            runs["torch_take"] = [cs.library_call("pack_rows", a) for a, _ in calls]
        if kernel in cs.DEVICE_TIMED:
            graphs = {name: cs.graph_replay_ms(rs) for name, rs in runs.items()}
        torch.cuda.synchronize()
        order = list(runs)
        rounds = {name: {"ms": [], "host_us": [], "device_ms": []} for name in order}
        for rnd in range(opt.rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                ms, host = zip(*(timed(r) for r in runs[name]))
                rounds[name]["ms"].append(sum(ms))
                rounds[name]["host_us"].append(sum(host))
                if kernel in cs.DEVICE_TIMED:
                    per_call = [t() for t in graphs[name]]
                    rounds[name]["device_ms"].append(sum(per_call))
                    rounds[name].setdefault("device_per_call", []).append(per_call)
        res = {"set": set_name, "calls": len(calls),
               "lanes": sorted({lanes(kernel, a) for a, _ in calls}),
               "exact": exact, "card": smi}
        for key in ("ms", "host_us", "device_ms"):
            med = {n: statistics.median(v[key]) for n, v in rounds.items() if v[key]}
            if med:
                res[key] = med
        per_call = {n: [statistics.median(c) for c in zip(*v.pop("device_per_call"))]
                    for n, v in rounds.items() if "device_per_call" in v}
        if per_call:
            res["device_ms_per_call"] = per_call
        res["rounds"] = rounds
        results.append(res)
        print(json.dumps(res), flush=True)
    if "encode_e2e" in wanted:
        res = encode_e2e(trees, decoded, names, opt.rounds, smi)
        results.append(res)
        print(json.dumps({k: v for k, v in res.items() if k != "rounds"}), flush=True)
    out = ROOT / "chiprun_out" / "kernel_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(smi, flush=True)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
