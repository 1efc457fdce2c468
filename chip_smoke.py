#!/usr/bin/env python3
"""Smoke run of the PyTorch port's decode path on one CUDA card.

    python3 chip_smoke.py

It needs one CUDA device, the CUDA toolkit (``nvcc``) and this
repository's checkout; it imports nothing of JAX.  Phases, each fatal
on failure:

1. build — the three CUDA kernels (``alacnet_tpu_torch/csrc/*.cu``,
   one nvcc call) and the native host tier, from the checkout's sources,
   into ``alacnet_tpu_torch/_build/``; prints the build times and the
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
   printed beside the card's name and power limit.

Numbers go on JSON lines; the last line is
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
}
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


def compare_kernels(calls) -> dict:
    """Each recorded call through the kernel and the plain version."""
    import torch

    from alacnet_tpu_torch.ops.cuda import bulk_bits, pack_rows, rice_lpc

    fns = {
        "pack_rows": pack_rows.pack_rows,
        "rice_lpc": rice_lpc.fused_rice_lpc,
        "bulk_bits": bulk_bits.bulk_bits,
    }
    results = {}
    for name, recorded in calls.items():
        if not recorded:
            raise RuntimeError(f"the main path made no {name} call")
        fn = fns[name]
        err, ms, plain_ms, shapes = 0, 0.0, 0.0, []
        # Warm-up: both versions on the first recorded call.
        args, kw = recorded[0]
        fn(*args, **{**kw, "kernel": "cuda"})
        fn(*args, **{**kw, "kernel": "torch"})
        torch.cuda.synchronize()
        for args, kw in recorded:
            got = fn(*args, **{**kw, "kernel": "cuda"})
            ms += cuda_ms(lambda: fn(*args, **{**kw, "kernel": "cuda"}), 5)
            plain = []
            plain_ms += cuda_ms(
                lambda: plain.append(fn(*args, **{**kw, "kernel": "torch"})), 1
            )
            got = got if isinstance(got, tuple) else (got,)
            want = plain[0] if isinstance(plain[0], tuple) else (plain[0],)
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise RuntimeError(f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
                if g.numel():
                    d = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
                    err = max(err, d)
            if err != 0:  # the tolerance: bit for bit
                raise RuntimeError(f"{name}: kernel differs from plain, max |err| {err}")
            shapes.append(list(got[0].shape))
        results[name] = {
            "calls": len(recorded), "shapes": shapes, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
        }
        emit({"kernel_check": name, **results[name]})
    return results


def run_e2e(names, data, expected, config, card: str) -> dict:
    import torch

    import alacnet_tpu_torch
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.utils.observability import GLOBAL_STATS

    # Device time from CUDA events: an event pair around each piece of
    # device work the pipeline queues (it spans launch gaps inside a
    # dispatch, so it bounds the busy time from above).
    intervals = []

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

    _lib.reset_launches()
    GLOBAL_STATS.reset()
    streams = pooled_streams(names, data)
    torch.cuda.synchronize()
    with wrapped(DEVICE_SITES, make):
        t0 = time.perf_counter()
        results = alacnet_tpu_torch.decode_streams(streams, config=config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    stats = GLOBAL_STATS.snapshot()
    event_ms = sum(a.elapsed_time(b) for a, b in intervals)

    for i, r in enumerate(results):
        name = names[i // COPIES]
        h = hashlib.sha256(r.pcm.astype(r.pcm.dtype.newbyteorder("<")).tobytes()).hexdigest()
        if h != expected[name]["sha256"] or list(r.pcm.shape) != expected[name]["shape"]:
            raise RuntimeError(f"PCM of {name} (copy {i % COPIES}) differs from expected.json")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"the main path launched no {missing} kernel")
    frames = sum(expected[n]["frames"] for n in names) * COPIES
    samples = stats["samples"]
    if samples != sum(expected[n]["samples"] for n in names) * COPIES:
        raise RuntimeError(f"decoded {samples} samples, expected more")

    # Device-busy time: one more run under torch.profiler.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        alacnet_tpu_torch.decode_streams(pooled_streams(names, data), config=config)
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
    e2e = {
        "frames": frames, "samples": samples, "wall_s": wall,
        "msamples_per_s": samples / wall / 1e6,
        "launches": launches, "stats": stats,
        "device_ms_events": event_ms, "device_share_events": event_ms / 1e3 / wall,
        "profiled_wall_s": prof_wall,
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / prof_wall if busy_us else "not measured",
        "device_ms_by_op": top, "card": card,
    }
    emit({"e2e": e2e})
    return e2e


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

    config = alacnet_tpu_torch.DecodeConfig(device="cuda")
    names, data, expected = load_corpus()
    calls = record_calls(names, data, config)
    checks = compare_kernels(calls)
    del calls
    torch.cuda.empty_cache()

    e2e = run_e2e(names, data, expected, config, smi)
    kernels = [
        {"name": k, "route": "cuda", "source": f"alacnet_tpu_torch/csrc/{k}.cu",
         "replaces": KERNELS[k], "launches": e2e["launches"][k],
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
