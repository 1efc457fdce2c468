#!/usr/bin/env python3
"""Smoke run of the PyTorch port's decode and encode paths on one CUDA card.

    python3 chip_smoke.py

It needs one CUDA device, the CUDA toolkit (``nvcc``) and this
repository's checkout; it imports nothing of JAX.  Phases, each fatal
on failure:

1. build — the five CUDA kernels (``alacnet_tpu_torch/csrc/*.cu``, one
   nvcc process per source, all at once, then one link) and the native
   host tier, from the checkout's sources, into
   ``alacnet_tpu_torch/_build/``; prints the build times and the
   compiler's register/spill report;
2. kernels — one pass of the pooled decode below, recording every call
   of ``pack_rows``, ``fused_rice_lpc`` and ``bulk_bits`` that the main
   path makes; each recorded call is then run through the CUDA kernel
   and through its plain torch version on the same card tensors, must
   match bit for bit, and is timed with CUDA events after a warm-up;
3. e2e — ``alacnet_tpu_torch.decode_streams`` on the 8 smoke files
   (``tests/fixtures/torch_smoke``), each given 96 times as an
   in-memory stream (11,520 frames); every file's PCM sha256 must equal
   ``expected.json`` (the JAX package's decode), all three kernels'
   launch counts must rise, and the rate, the wall time and the
   device time (CUDA events around the device work the pipeline queues;
   and, from a second run under torch.profiler, the busy time by op) are
   printed beside the card's name and power limit;
4. encode kernels — one pooled ``alacnet_tpu_torch.encode_files(
   device="cuda")`` run over the PCM that phase 3 decoded (each file 96
   times: 10,944 frames of 4096 samples — orders.m4a's 16 short frames
   re-encode as 10 — in 12 chunks of at most 1024 frames, three
   format groups), recording every ``predictor_errors_fused`` and
   ``rice_merge_fused`` call; every recorded call runs through the CUDA
   kernel (timed with CUDA events), and the first call of each format
   group — then further calls while the plain total stays under
   ``PLAIN_BUDGET_S`` — through the plain torch version too, bit for
   bit; the lines say which calls were compared;
5. encode e2e — the same pooled ``encode_files`` run with
   ``EncoderConfig()``, then hires24 and fat24 again with
   ``EncoderConfig(uncompressed_bytes=1)`` (the extra-bits plane): every
   output's sha256 must equal ``encode_expected.json`` (the JAX
   package's encoder), one copy per file must equal the port's host
   ``AlacEncoder``, every output must decode on the card back to the PCM
   of ``expected.json``, the native pair packer must be the packer that
   ran, and both encode kernels' launch counts must rise; the rate, the
   wall time, the stage times, the device time from CUDA events and a
   profiler busy-by-op are printed beside the card's name and power
   limit.

In the ``kernels`` line, ``ms`` and ``plain_ms`` are sums over the same
calls: every recorded call for the decode kernels, the compared calls
for the encode kernels (the ``kernel_check`` lines give the kernel time
over every call).  Numbers go on JSON lines; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without CUDA, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import io
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
CORPUS = ROOT / "tests" / "fixtures" / "torch_smoke"
COPIES = 96
#: The TPU kernel each CUDA kernel replaces (its pl.pallas_call).
KERNELS = {
    "pack_rows": "alacnet_tpu/ops/pallas/pack_rows.py:227",
    "rice_lpc": "alacnet_tpu/ops/pallas/rice_lpc.py:940",
    "bulk_bits": "alacnet_tpu/ops/pallas/bulk_bits.py:360",
    "enc_pred": "alacnet_tpu/ops/pallas/enc_stages.py:382",
    "enc_rice": "alacnet_tpu/ops/pallas/enc_stages.py:473",
}
DECODE_KERNELS = ("pack_rows", "rice_lpc", "bulk_bits")
ENCODE_KERNELS = ("enc_pred", "enc_rice")
#: Seconds of plain-version runs phase 4 may spend past the first call
#: of each format group: half for each encode kernel.
PLAIN_BUDGET_S = 120.0
#: Where encode_stages_fused calls each encode kernel wrapper.
ENC_CALL_SITES = {
    k: ("alacnet_tpu_torch.ops.cuda.enc_stages", attr)
    for k, attr in (("enc_pred", "predictor_errors_fused"),
                    ("enc_rice", "rice_merge_fused"))
}
#: Where encode_files runs each format group through the device encoder.
ENCODE_DEVICE = {"run": ("alacnet_tpu_torch.codec.encoder_device", "encode_frames_device")}
#: The encode files of phase 5's second run, with the extra-bits plane.
UB1_FILES = ("fat24.m4a", "hires24.m4a")
#: Where the pipeline queues device work: the blob upload, each batch's
#: dispatch (H2D, kernels, epilogue) and its D2H copy.
DEVICE_SITES = {
    k: ("alacnet_tpu_torch.parallel.pipeline", k)
    for k in ("blob_words", "dispatch_frame_batch", "d2h_async")
}
#: Where frame_decode / pipeline call each kernel wrapper.
CALL_SITES = {
    "pack_rows": ("alacnet_tpu_torch.parallel.pipeline", "pack_rows"),
    "rice_lpc": ("alacnet_tpu_torch.ops.frame_decode", "fused_rice_lpc"),
    "bulk_bits": ("alacnet_tpu_torch.ops.frame_decode", "bulk_bits"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_ms(fn, reps: int) -> float:
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def load_corpus():
    expected = json.loads((CORPUS / "expected.json").read_text())
    names = sorted(expected)
    return names, {n: (CORPUS / n).read_bytes() for n in names}, expected


def pooled_streams(names, data):
    return [io.BytesIO(data[n]) for n in names for _ in range(COPIES)]


@contextlib.contextmanager
def wrapped(sites, make):
    """Replace each call site ``sites[key] = (module, attr)`` with
    ``make(key, original)`` for the duration of the block."""
    saved = []
    for key, (mod_name, attr) in sites.items():
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, make(key, saved[-1][2]))
    try:
        yield
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def record_calls(names, data, config):
    """Run the pooled decode once with every kernel wrapper's call site
    wrapped, and return {kernel: [(args, kwargs), ...]} as called."""
    import alacnet_tpu_torch

    calls = {k: [] for k in CALL_SITES}

    def make(key, orig):
        def rec(*args, **kwargs):
            calls[key].append((args, kwargs))
            return orig(*args, **kwargs)
        return rec

    with wrapped(CALL_SITES, make):
        alacnet_tpu_torch.decode_streams(pooled_streams(names, data), config=config)
    return calls


def compare_kernels(calls, fns, groups=None, budget_s=None) -> dict:
    """Each recorded call through the kernel, and through the plain
    version too: every call, or — with ``groups`` (each call's format
    group) — the first call of each group, then further calls while the
    kernel's plain total stays under ``budget_s``."""
    import torch

    results = {}
    for name, recorded in calls.items():
        if not recorded:
            raise RuntimeError(f"the main path made no {name} call")
        fn = fns[name]
        err, ms, ms_all, plain_ms, shapes, compared = 0, 0.0, 0.0, 0.0, [], []
        seen = set()
        # Warm-up: both versions on the first recorded call.
        args, kw = recorded[0]
        fn(*args, **{**kw, "kernel": "cuda"})
        fn(*args, **{**kw, "kernel": "torch"})
        torch.cuda.synchronize()
        for idx, (args, kw) in enumerate(recorded):
            got = fn(*args, **{**kw, "kernel": "cuda"})
            k_ms = cuda_ms(lambda: fn(*args, **{**kw, "kernel": "cuda"}), 5)
            ms_all += k_ms
            got = got if isinstance(got, tuple) else (got,)
            shapes.append(list(got[0].shape))
            group = None if groups is None else groups[name][idx]
            if groups is not None and group in seen and plain_ms / 1e3 >= budget_s:
                continue
            seen.add(group)
            plain = []
            plain_ms += cuda_ms(
                lambda: plain.append(fn(*args, **{**kw, "kernel": "torch"})), 1
            )
            ms += k_ms
            compared.append(idx)
            want = plain[0] if isinstance(plain[0], tuple) else (plain[0],)
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise RuntimeError(f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
                if g.numel():
                    d = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
                    err = max(err, d)
            if err != 0:  # the tolerance: bit for bit
                raise RuntimeError(f"{name}: kernel differs from plain, max |err| {err}")
        results[name] = {
            "calls": len(recorded), "compared_calls": compared, "shapes": shapes,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "ms_all_calls": ms_all,
        }
        emit({"kernel_check": name, **results[name]})
    return results


def decode_fns() -> dict:
    from alacnet_tpu_torch.ops.cuda import bulk_bits, pack_rows, rice_lpc

    return {
        "pack_rows": pack_rows.pack_rows,
        "rice_lpc": rice_lpc.fused_rice_lpc,
        "bulk_bits": bulk_bits.bulk_bits,
    }


def event_timer(intervals):
    """A ``wrapped`` factory: an event pair around each call of the site
    (it spans launch gaps inside the call, so it bounds the busy time
    from above)."""
    import torch

    def make(key, orig):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args, **kwargs)
            stop.record()
            intervals.append((start, stop))
            return out
        return timed
    return make


def profile_busy(run) -> dict:
    """Run ``run()`` under torch.profiler; the device-busy time and the
    busiest ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    # Sum the device-side events only (kernels and copies): a CPU op's
    # device time repeats that of the kernels it launched.
    by_kernel = {}
    busy_us = 0.0
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            busy_us += dev_us
            by_kernel[ev.key[:60]] = dev_us / 1e3
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    return {
        "profiled_wall_s": prof_wall,
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / prof_wall if busy_us else "not measured",
        "device_ms_by_op": top,
    }


def pcm_sha(pcm) -> str:
    return hashlib.sha256(pcm.astype(pcm.dtype.newbyteorder("<")).tobytes()).hexdigest()


def run_e2e(names, data, expected, config, card: str):
    """Phase 3.  Returns the e2e numbers and one decoded copy per file."""
    import torch

    import alacnet_tpu_torch
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.utils.observability import GLOBAL_STATS

    intervals = []
    _lib.reset_launches()
    GLOBAL_STATS.reset()
    streams = pooled_streams(names, data)
    torch.cuda.synchronize()
    with wrapped(DEVICE_SITES, event_timer(intervals)):
        t0 = time.perf_counter()
        results = alacnet_tpu_torch.decode_streams(streams, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    stats = GLOBAL_STATS.snapshot()
    event_ms = sum(a.elapsed_time(b) for a, b in intervals)

    for i, r in enumerate(results):
        name = names[i // COPIES]
        if pcm_sha(r.pcm) != expected[name]["sha256"] or list(r.pcm.shape) != expected[name]["shape"]:
            raise RuntimeError(f"PCM of {name} (copy {i % COPIES}) differs from expected.json")
    missing = [k for k in DECODE_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"the main path launched no {missing} kernel")
    frames = sum(expected[n]["frames"] for n in names) * COPIES
    samples = stats["samples"]
    if samples != sum(expected[n]["samples"] for n in names) * COPIES:
        raise RuntimeError(f"decoded {samples} samples, expected more")
    decoded = {names[i // COPIES]: r for i, r in enumerate(results) if i % COPIES == 0}
    del results

    # Device-busy time: one more run under torch.profiler.
    busy = profile_busy(
        lambda: alacnet_tpu_torch.decode_streams(pooled_streams(names, data), config=config)
    )
    e2e = {
        "frames": frames, "samples": samples, "wall_s": wall,
        "msamples_per_s": samples / wall / 1e6,
        "launches": launches, "stats": stats,
        "device_ms_events": event_ms, "device_share_events": event_ms / 1e3 / wall,
        **busy, "card": card,
    }
    emit({"e2e": e2e})
    return e2e, decoded


def encode_pooled(decoded, names, config) -> list[bytes]:
    """``encode_files(device="cuda")`` on each file's PCM, COPIES times
    over, pooled; the output bytes in input order."""
    import alacnet_tpu_torch

    files = [decoded[n] for n in names for _ in range(COPIES)]
    outs = [io.BytesIO() for _ in files]
    alacnet_tpu_torch.encode_files(
        [r.pcm for r in files], outs, [r.sample_rate for r in files],
        [r.bits_per_sample for r in files], config=config, device="cuda",
    )
    return [o.getvalue() for o in outs]


def record_enc_calls(decoded, names):
    """Phase 4's recording run: {kernel: [(args, kwargs), ...]} as the
    pooled encode called the wrappers, and each call's format group (one
    ``encode_frames_device`` run per group)."""
    import alacnet_tpu_torch

    calls = {k: [] for k in ENC_CALL_SITES}
    groups = {k: [] for k in ENC_CALL_SITES}
    group = [-1]

    def make(key, orig):
        def rec(*args, **kwargs):
            calls[key].append((args, kwargs))
            groups[key].append(group[0])
            return orig(*args, **kwargs)
        return rec

    def per_group(key, orig):
        def run(*args, **kwargs):
            group[0] += 1
            return orig(*args, **kwargs)
        return run

    with wrapped(ENC_CALL_SITES, make), wrapped(ENCODE_DEVICE, per_group):
        encode_pooled(decoded, names, alacnet_tpu_torch.EncoderConfig())
    return calls, groups


def enc_fns() -> dict:
    from alacnet_tpu_torch.ops.cuda import enc_stages

    return {
        "enc_pred": enc_stages.predictor_errors_fused,
        "enc_rice": enc_stages.rice_merge_fused,
    }


def check_encoded(datas, names, decoded, cfg_name, config, enc_expected, expected):
    """Every output against encode_expected.json; one copy per file
    against the port's host encoder; every output decoded on the card
    back to expected.json's PCM."""
    import alacnet_tpu_torch

    for i, d in enumerate(datas):
        name = names[i // COPIES]
        want = enc_expected[f"{name}|{cfg_name}"]
        if len(d) != want["bytes"] or hashlib.sha256(d).hexdigest() != want["sha256"]:
            raise RuntimeError(f"{name} ({cfg_name}, copy {i % COPIES}) differs "
                               "from encode_expected.json")
    for j, name in enumerate(names):
        r = decoded[name]
        out = io.BytesIO()
        alacnet_tpu_torch.encode_files([r.pcm], [out], r.sample_rate, r.bits_per_sample,
                                       config=config, device=None)
        if out.getvalue() != datas[j * COPIES]:
            raise RuntimeError(f"{name} ({cfg_name}) differs from the host AlacEncoder")
    back = alacnet_tpu_torch.decode_streams([io.BytesIO(d) for d in datas], device="cuda")
    for i, r in enumerate(back):
        name = names[i // COPIES]
        if pcm_sha(r.pcm) != expected[name]["sha256"]:
            raise RuntimeError(f"{name} ({cfg_name}, copy {i % COPIES}) does not "
                               "decode back to expected.json")


def run_encode_e2e(decoded, names, expected, enc_expected, card: str) -> dict:
    """Phase 5."""
    import torch

    import alacnet_tpu_torch
    from alacnet_tpu_torch.ops.cuda import _lib

    packers = {"pair": 0, "chunk": 0}
    pack_sites = {
        "pair": ("alacnet_tpu_torch.native", "pack_pair_frames_native"),
        "chunk": ("alacnet_tpu_torch.native", "pack_chunk_frames_native"),
    }

    def count(key, orig):
        def run(*args, **kwargs):
            packers[key] += 1
            return orig(*args, **kwargs)
        return run

    timings: dict = {}

    def with_timings(key, orig):
        def run(*args, **kwargs):
            return orig(*args, **{**kwargs, "timings": timings})
        return run

    intervals = []
    dispatch_site = {"dispatch": ("alacnet_tpu_torch.codec.encoder_device", "_dispatch")}
    config = alacnet_tpu_torch.EncoderConfig()
    torch.cuda.synchronize()
    _lib.reset_launches()
    with wrapped(pack_sites, count), wrapped(ENCODE_DEVICE, with_timings), \
            wrapped(dispatch_site, event_timer(intervals)):
        t0 = time.perf_counter()
        datas = encode_pooled(decoded, names, config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    event_ms = sum(a.elapsed_time(b) for a, b in intervals)
    missing = [k for k in ENCODE_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"the encode path launched no {missing} kernel")
    if packers["pair"] != len(intervals) or packers["chunk"]:
        raise RuntimeError(f"the pair packer did not pack every chunk: {packers}, "
                           f"{len(intervals)} chunks")
    check_encoded(datas, names, decoded, "default", config, enc_expected, expected)
    del datas
    busy = profile_busy(lambda: encode_pooled(decoded, names, config))

    # The extra-bits plane: the 24-bit files again with ub = 1.
    ub1 = alacnet_tpu_torch.EncoderConfig(uncompressed_bytes=1)
    _lib.reset_launches()
    t1 = time.perf_counter()
    datas = encode_pooled(decoded, UB1_FILES, ub1)
    torch.cuda.synchronize()
    ub1_wall = time.perf_counter() - t1
    ub1_launches = dict(_lib.LAUNCHES)
    if any(ub1_launches.get(k, 0) == 0 for k in ENCODE_KERNELS):
        raise RuntimeError(f"the ub1 run launched no encode kernel: {ub1_launches}")
    check_encoded(datas, UB1_FILES, decoded, "ub1", ub1, enc_expected, expected)

    def enc_frames(files, cfg_name):
        return sum(enc_expected[f"{n}|{cfg_name}"]["frames"] for n in files) * COPIES

    samples = sum(expected[n]["samples"] for n in names) * COPIES
    out = {
        "frames": enc_frames(names, "default"),
        "samples": samples, "chunks": len(intervals), "wall_s": wall,
        "msamples_per_s": samples / wall / 1e6, "launches": launches,
        "timings": timings, "packers": packers,
        "device_ms_events": event_ms, "device_share_events": event_ms / 1e3 / wall,
        **busy,
        "ub1": {"frames": enc_frames(UB1_FILES, "ub1"),
                "wall_s": ub1_wall, "launches": ub1_launches},
        "card": card,
    }
    emit({"encode_e2e": out})
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    if not (ROOT / "alacnet_tpu_torch").is_dir() or not CORPUS.is_dir():
        return fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    import alacnet_tpu_torch
    from alacnet_tpu_torch import native
    from alacnet_tpu_torch.ops.cuda import _lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"device": kind, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _lib.get_lib()
    t1 = time.perf_counter()
    native_lib = native.get_lib()
    t2 = time.perf_counter()
    ptxas = [ln.strip() for ln in _lib.BUILD_INFO.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"build": {"kernels_s": t1 - t0, "nvcc_s": _lib.BUILD_INFO.get("seconds"),
                    "native_s": t2 - t1,
                    "host_parser": "native" if native_lib is not None else "numpy",
                    "ptxas": ptxas}})
    if native_lib is None:
        raise RuntimeError("the native host tier did not build: the pair packer needs it")

    config = alacnet_tpu_torch.DecodeConfig(device="cuda")
    names, data, expected = load_corpus()
    calls = record_calls(names, data, config)
    checks = compare_kernels(calls, decode_fns())
    del calls
    torch.cuda.empty_cache()

    e2e, decoded = run_e2e(names, data, expected, config, smi)
    enc_expected = json.loads((CORPUS / "encode_expected.json").read_text())

    calls, groups = record_enc_calls(decoded, names)
    checks.update(compare_kernels(calls, enc_fns(), groups, PLAIN_BUDGET_S / 2))
    del calls
    torch.cuda.empty_cache()

    enc = run_encode_e2e(decoded, names, expected, enc_expected, smi)
    launches = {**e2e["launches"], **enc["launches"]}
    kernels = [
        {"name": k, "route": "cuda", "source": f"alacnet_tpu_torch/csrc/{k}.cu",
         "replaces": KERNELS[k], "launches": launches[k],
         "max_abs_err": checks[k]["max_abs_err"], "ms": checks[k]["ms"],
         "plain_ms": checks[k]["plain_ms"]}
        for k in KERNELS
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
