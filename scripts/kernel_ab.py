#!/usr/bin/env python3
"""A/B of the port's kernel wrappers against another tree's, in one
process on one CUDA card.

    python3 scripts/kernel_ab.py OTHER [--rounds N] [--sets NAME ...]

OTHER is the root of another checkout of this repo, for example the
parent commit unpacked into the git-ignored ``_checkout/``::

    mkdir -p _checkout/parent && git archive HEAD~1 | tar -x -C _checkout/parent
    python3 scripts/kernel_ab.py _checkout/parent

Its ``alacnet_tpu_torch`` is imported under another name beside
this tree's, so both trees' real wrappers (each builds its own tree's
kernels) run on the same inputs: the main paths' calls, recorded on the
card as ``chip_smoke.py`` records them.

- ``pack_rows``, ``rice_lpc``: every call of one pooled
  ``decode_streams`` of the smoke corpus, each file 96 times;
- ``rice_lpc_session``: every ``rice_lpc`` call of one
  ``AlacContext.read_all`` of ``chip_smoke.py``'s long stream (a pass
  per 64-frame window);
- ``enc_pred``, ``enc_rice``: every ``predictor_errors_fused`` and
  ``rice_merge_fused`` call of one pooled ``encode_files(device="cuda")``
  of the decoded smoke corpus (``chip_smoke.py`` phase 4's recording:
  12 calls of up to 2048 lanes).

Every output of the other tree must equal this tree's, bit for bit.  Per round, each wrapper (and for ``pack_rows``
``torch.take`` of the same rows) runs every call of a set, in turns, the
order reversed every other round.  Each figure is the median over
``--rounds`` rounds of a sum over the set's calls of:

- ``ms``: 5 calls from the host, CUDA events around them (the wrapper's
  host work counts where it outlasts the kernel);
- ``host_us``: the host's time per call in those 5 calls, before the
  wait for the card;
- ``device_ms`` (``pack_rows`` only): a CUDA graph of 5 calls replayed,
  the card alone (``chip_smoke.graph_replay_ms``).

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

#: The name the other tree's package is imported under.
OTHER = "other_alacnet_tpu_torch"


def load_wrappers(root: pathlib.Path) -> dict:
    """{kernel: wrapper} of the ``alacnet_tpu_torch`` under ``root``,
    imported as ``OTHER`` (the package imports itself relatively)."""
    pkg = root / "alacnet_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        OTHER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    enc = importlib.import_module(f"{OTHER}.ops.cuda.enc_stages")
    return {"pack_rows": importlib.import_module(f"{OTHER}.ops.cuda.pack_rows").pack_rows,
            "rice_lpc": importlib.import_module(f"{OTHER}.ops.cuda.rice_lpc").fused_rice_lpc,
            "enc_pred": enc.predictor_errors_fused, "enc_rice": enc.rice_merge_fused}


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=pathlib.Path, help="root of the other checkout")
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
    other = load_wrappers(opt.other.resolve())
    wanted = set(opt.sets or ("pack_rows", "rice_lpc", "rice_lpc_session", "enc_pred", "enc_rice"))

    names, data, _ = cs.load_corpus()
    sets = {}
    if wanted & {"pack_rows", "rice_lpc"}:
        pooled, _ = cs.record_calls(names, data, alacnet_tpu_torch.DecodeConfig(device="cuda"))
        sets.update({"pack_rows": ("pack_rows", pooled["pack_rows"]),
                     "rice_lpc": ("rice_lpc", pooled["rice_lpc"])})
    if "rice_lpc_session" in wanted:
        music = alacnet_tpu_torch.decode_file(cs.CORPUS / "music.m4a", device="cuda")
        sets["rice_lpc_session"] = ("rice_lpc", cs.record_session_calls(cs.long_stream(music)[1]))
    if wanted & {"enc_pred", "enc_rice"}:
        decoded = dict(zip(names, alacnet_tpu_torch.decode_streams(
            [io.BytesIO(data[n]) for n in names], device="cuda")))
        enc_calls, _, _ = cs.record_enc_calls(decoded, names)
        sets.update({k: (k, enc_calls[k]) for k in ("enc_pred", "enc_rice")})
    sets = {k: v for k, v in sets.items() if k in wanted}

    results = []
    for set_name, (kernel, calls) in sets.items():
        runs = {tree: [lambda a=a, kw=kw, f=fns[kernel]: f(*a, **{**kw, "kernel": "cuda"})
                       for a, kw in calls]
                for tree, fns in (("port", port), ("other", other))}
        exact = all(same(r(), ref()) for r, ref in zip(runs["other"], runs["port"]))
        if kernel == "pack_rows":
            runs["torch_take"] = [cs.library_call("pack_rows", a) for a, _ in calls]
            graphs = {name: cs.graph_replay_ms(rs) for name, rs in runs.items()}
        torch.cuda.synchronize()
        order = list(runs)
        rounds = {name: {"ms": [], "host_us": [], "device_ms": []} for name in order}
        for rnd in range(opt.rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                ms, host = zip(*(timed(r) for r in runs[name]))
                rounds[name]["ms"].append(sum(ms))
                rounds[name]["host_us"].append(sum(host))
                if kernel == "pack_rows":
                    rounds[name]["device_ms"].append(sum(t() for t in graphs[name]))
        res = {"set": set_name, "calls": len(calls),
               "lanes": sorted({a[1].shape[0] if kernel == "pack_rows" else a[0].shape[0]
                                for a, _ in calls}),
               "exact": exact, "card": smi}
        for key in ("ms", "host_us", "device_ms"):
            med = {n: statistics.median(v[key]) for n, v in rounds.items() if v[key]}
            if med:
                res[key] = med
        res["rounds"] = rounds
        results.append(res)
        print(json.dumps(res), flush=True)
    out = ROOT / "chiprun_out" / "kernel_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(smi, flush=True)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
