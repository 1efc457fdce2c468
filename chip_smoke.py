#!/usr/bin/env python3
"""Smoke run of the PyTorch port's decode and encode paths on one CUDA card.

    python3 chip_smoke.py

It needs one CUDA device, the CUDA toolkit (``nvcc``) and this
repository's checkout; it imports nothing of JAX.  Phases, each fatal
on failure, each printing its seconds:

1. build — the six CUDA kernels (``alacnet_tpu_torch/csrc/*.cu``, one
   nvcc process per source, all at once, then one link) and the native
   host tier, from the checkout's sources, into
   ``alacnet_tpu_torch/_build/``; prints the build times and the
   compiler's register/spill report;
2. kernels — one pass of the pooled decode below, recording every call
   of ``pack_rows``, ``fused_rice_lpc`` and ``bulk_bits`` that the main
   path makes, and each call's group: its place in the frame batch
   (channel A or B) and the batch's formats (channels, bits, extra
   bits, raw frames); each recorded call is run through the CUDA kernel
   (timed with CUDA events after a warm-up), and the first call of each
   group — then further calls while the kernel's plain total stays under
   ``PLAIN_BUDGET_S`` — through its plain torch version on the same card
   tensors too, bit for bit; ``pack_rows`` and ``bulk_bits`` are timed on
   the card alone too (CUDA-graph replays);
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
   ``rice_merge_fused`` call and, per chunk, the host prep and the
   payloads the production pair packer wrote; every recorded call runs
   through the CUDA kernel (timed with CUDA events), and the first call
   of each format group — then further calls while the plain total
   stays under ``PLAIN_BUDGET_S`` — through the plain torch version
   too, bit for bit; the lines say which calls were compared;
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
   limit;
6. symbol-plane route — every recorded ``rice_merge_fused`` call of
   phase 4 (its arguments are ``rice_symbols``') through
   ``rice_symbols_fused`` on the card (the ``rice_emit`` kernel), its
   planes packed by the native symbol packer with the chunk's header
   arrays: the payloads must equal, byte for byte, the ones the
   production path wrote for that chunk, and ``rice_emit`` launches
   must rise; then every call through the kernel, and the first call of
   each format group — then more within ``PLAIN_BUDGET_S`` — through the
   plain version too, every plane bit for bit everywhere (the values too
   where their width is 0);
7. public API on the card — for each smoke file, ``AlacContext``
   (window 4, the readahead serving windows), ``ALACFileReader`` after a
   seek to the middle, and ``decode_resumable`` in chunks of 5 frames,
   each against ``expected.json``; the CLI's ``batch-decode``,
   ``verify``, ``batch-encode`` and ``encode`` (all at their default
   device, ``cuda``) against ``expected.json`` and
   ``encode_expected.json``; ``rice_lpc`` launches must rise.  Then the
   session API's read rate over one long stream (the music file's PCM
   tiled to 1,504 frames, encoded by the port): ``AlacContext.read_all``
   at the default window and ``ALACFileReader.read(65536)`` loops, and
   ``rice_lpc``'s time per pass at that shape (the calls of one more
   ``read_all``, each through the kernel again, CUDA events).

In the ``kernels`` line, ``ms`` is the kernel's time summed over every
call the path made (mean of 5 launches each from the host, CUDA
events around them: the wrapper's host work counts where it outlasts
the kernel; ``device_ms``, where present, is the time on the card
alone, from CUDA-graph replays), ``plain_ms`` the plain
version's over the compared calls (``plain_calls`` of ``calls``);
``bytes`` is what those calls must move (each input byte read once,
each output byte written once, counting what the data needs: live
samples, the coded bits a lane consumes), ``int_ops`` an estimate of
their int32 operations (``INT_OPS``), and ``bound_ms`` the sum over
the calls of the larger of bytes over ``HBM_BYTES_PER_S`` and
operations over ``INT32_OPS_PER_S``; ``library_ms`` is the time of one
PyTorch call computing the same function on the same inputs where one
exists (``pack_rows``: ``torch.take`` of the rows, timed as ``ms``),
else null; the ``kernel_check`` line also times the two in turns
(``time_against_library``), and ``library_over_kernel`` is the ratio of
their medians from the host.  ``DEVICE_TIMED`` kernels (``pack_rows``,
``bulk_bits``) also get ``device_ms`` and ``device_bound_share`` (bound
over card-alone time) in their ``kernel_check`` line, and ``bulk_bits``
``interface_bytes`` and ``interface_bound_ms``: the bytes with the zeros
its full (B, S) planes hold past each lane's n.  Numbers
go on JSON lines; the last line is
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
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
CORPUS = ROOT / "tests" / "fixtures" / "torch_smoke"
COPIES = 96
#: The torch device every phase runs on.
DEVICE = "cuda"
#: The TPU kernel each CUDA kernel replaces (its pl.pallas_call).
KERNELS = {
    "pack_rows": "alacnet_tpu/ops/pallas/pack_rows.py:227",
    "rice_lpc": "alacnet_tpu/ops/pallas/rice_lpc.py:940",
    "bulk_bits": "alacnet_tpu/ops/pallas/bulk_bits.py:360",
    "enc_pred": "alacnet_tpu/ops/pallas/enc_stages.py:382",
    "enc_rice": "alacnet_tpu/ops/pallas/enc_stages.py:473",
    "rice_emit": "alacnet_tpu/ops/pallas/rice_emit.py:219",
}
#: The path whose run each kernel's launch count comes from.
KERNEL_PATHS = {
    **dict.fromkeys(("pack_rows", "rice_lpc", "bulk_bits"), "decode_streams"),
    **dict.fromkeys(("enc_pred", "enc_rice"), "encode_files"),
    "rice_emit": "symbol-plane route",
}
DECODE_KERNELS = ("pack_rows", "rice_lpc", "bulk_bits")
ENCODE_KERNELS = ("enc_pred", "enc_rice")
#: Seconds of plain-version runs each kernel's check may spend past the
#: first call of each group (the plain rice_lpc and predictor take
#: ~11-13 s a call on the H100).
PLAIN_BUDGET_S = 40.0
#: H100 SXM device memory rate, bytes/s (NVIDIA's data sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM int32 issue rate, ops/s: 132 SMs x 64 INT32 lanes x the
#: 1.98 GHz boost clock (NVIDIA's Hopper white paper and data sheet).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: Estimated int32 operations per item of each kernel, counted from the
#: plain version's expressions: per live sample (``sample``), per FIR
#: tap of a live sample (``tap``), per output word (``word``).
INT_OPS = {
    "pack_rows": {"word": 6},
    "rice_lpc": {"sample": 40, "tap": 4},
    "bulk_bits": {"sample": 16},
    "enc_pred": {"sample": 20, "tap": 4},
    "enc_rice": {"sample": 135},
    "rice_emit": {"sample": 115},
}
#: Rounds of (kernel, library call) in turns per call where a library
#: call computes the kernel's function (``pack_rows``: ``torch.take``),
#: each timing 5 calls from the host and a CUDA graph of 5 calls.
ALT_ROUNDS = 7
#: Kernels whose calls are also timed on the card alone (``device_ms``):
#: tens of microseconds of kernel, under the wrapper's host work.
DEVICE_TIMED = ("pack_rows", "bulk_bits")
#: Frames per window and per resumable chunk of phase 7's checks.
API_WINDOW = 4
RESUME_FRAMES = 5
#: Copies of music.m4a's PCM (16 frames) in phase 7's long stream.
LONG_COPIES = 94
#: Where encode_stages_fused calls each encode kernel wrapper.
ENC_CALL_SITES = {
    k: ("alacnet_tpu_torch.ops.cuda.enc_stages", attr)
    for k, attr in (("enc_pred", "predictor_errors_fused"),
                    ("enc_rice", "rice_merge_fused"))
}
#: Where the encode pipeline packs each chunk's planes into payloads.
ENC_PACK = {"pack": ("alacnet_tpu_torch.codec.encoder_device", "_pack")}
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
#: Where the pipeline queues each frame batch's decode.
DISPATCH_SITE = {"dispatch": ("alacnet_tpu_torch.parallel.pipeline", "dispatch_frame_batch")}
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


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def batch_formats(fb) -> tuple:
    """The formats of a frame batch's live lanes: (stereo, bits, extra
    bits, compressed) each."""
    live = fb.n_samples > 0
    return tuple(sorted(set(zip(
        fb.is_stereo[live].tolist(), fb.sample_size[live].tolist(),
        (fb.ub[live] > 0).tolist(), fb.is_compressed[live].tolist(),
    ))))


def record_calls(names, data, config):
    """Run the pooled decode once with every kernel wrapper's call site
    wrapped; return {kernel: [(args, kwargs), ...]} as called, and each
    call's group: (its place among the batch's calls of that kernel,
    the batch's formats)."""
    import alacnet_tpu_torch

    calls = {k: [] for k in CALL_SITES}
    groups = {k: [] for k in CALL_SITES}
    batch = {}

    def make(key, orig):
        def rec(*args, **kwargs):
            place = batch["placed"].get(key, 0)
            batch["placed"][key] = place + 1
            groups[key].append((place, batch["formats"]))
            calls[key].append((args, kwargs))
            return orig(*args, **kwargs)
        return rec

    def per_batch(key, orig):
        def run(fb, *args, **kwargs):
            batch.update(formats=batch_formats(fb), placed={})
            return orig(fb, *args, **kwargs)
        return run

    with wrapped(CALL_SITES, make), wrapped(DISPATCH_SITE, per_batch):
        alacnet_tpu_torch.decode_streams(pooled_streams(names, data), config=config)
    return calls, groups


def _isum(t) -> int:
    import torch

    return int(t.to(torch.int64).sum().item())


def call_work(name: str, args, got) -> tuple[int, int]:
    """(bytes, int32 ops) one recorded call must move and do: each input
    byte read once, each output byte written once, counting what this
    call's data needs (live samples, the coded bits a lane consumes);
    the operations from ``INT_OPS``."""
    import torch

    ops = INT_OPS[name]
    if name == "pack_rows":
        _, ow, nbytes, W = args[:4]
        B = ow.shape[0]
        in_words = _isum(torch.clamp((nbytes + 3) // 4, 0, W))
        return 8 * B + 4 * in_words + 4 * B * W, ops["word"] * B * W
    if name == "rice_lpc":
        _, start, n = args[:3]
        order, S = args[8], args[11]
        end = got[1]
        B = n.shape[0]
        nn = torch.clamp(n, 0, S)
        live = _isum(nn)
        coded_words = _isum(torch.clamp((end - start + 31) // 32, min=0))
        taps = _isum(torch.where(order >= 31, 0, torch.clamp(order, 0)) * nn)
        # words; 9 per-lane params, the end out; 32 coefs; live samples out
        nbytes = 4 * coded_words + 40 * B + 128 * B + 4 * live
        return nbytes, ops["sample"] * live + ops["tap"] * taps
    if name == "bulk_bits":
        _, _, n, n1, n2, S = args[:6]
        nn = torch.clamp(n, 0, S)
        live = _isum(nn)
        field_bits = _isum(nn * (n1 + n2))
        return field_bits // 8 + 16 * n.shape[0] + 8 * live, ops["sample"] * live
    if name == "enc_pred":
        _, n, lp, S = args[:4]
        nn = torch.clamp(n, 0, S)
        live = _isum(nn)
        taps = _isum(torch.where(lp.order >= 31, 0, torch.clamp(lp.order, 0)) * nn)
        B = n.shape[0]
        return 8 * live + 16 * B + 128 * B, ops["sample"] * live + ops["tap"] * taps
    # enc_rice / rice_emit: residuals and zero runs in, the planes out
    _, _, n, _, S = args[:5]
    live = _isum(torch.clamp(n, 0, S))
    per_sample, per_lane = (8 + 13, 24 + 5) if name == "enc_rice" else (8 + 16, 24 + 1)
    return per_sample * live + per_lane * n.shape[0], ops["sample"] * live


def interface_bytes(name: str, args, work_bytes: int) -> int:
    """``call_work``'s bytes plus what the interface makes a call write
    beyond them: ``bulk_bits`` returns full (B, S) planes, so every
    sample past a lane's n is a zero to write."""
    import torch

    if name != "bulk_bits":
        return work_bytes
    _, _, n, _, _, S = args[:6]
    dead = n.shape[0] * S - _isum(torch.clamp(n, 0, S))
    return work_bytes + 8 * dead


def library_call(name: str, args):
    """A zero-argument callable of one PyTorch call computing the same
    function on the same inputs (index tensors built here, outside the
    timed region), or None where no single call does."""
    import torch

    if name != "pack_rows":
        return None  # sequential recurrences per lane: no such call
    bwords, ow, _, W = args[:4]
    flat = bwords.reshape(-1)
    idx = torch.clamp(
        ow.to(torch.int64)[:, None] + torch.arange(W, device=flat.device)[None, :],
        0, flat.numel() - 1,
    )
    return lambda: torch.take(flat, idx)


def graph_replay_ms(fns, reps: int = 5):
    """For each zero-argument callable, a function that times it on the
    card without the host in the way: ``reps`` calls captured in a CUDA
    graph (after a warm-up call), each timing one replay with CUDA
    events and returning ms per call.  The graphs keep their outputs,
    the timers their callables."""
    import torch

    timers = []
    for fn in fns:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        # Captured on a side stream by hand: ``torch.cuda.graph`` would
        # empty the allocator's cache first, and the next timing from
        # the host would then pay for fresh device allocations.
        with torch.cuda.stream(side):
            fn()
            graph.capture_begin()
            for _ in range(reps):
                fn()
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        # the timer holds fn too: the graph reads whatever fn's closure
        # holds (a library call's index tensor), which must outlive it
        timers.append(lambda g=graph, keep=fn: cuda_ms(g.replay, 1) / reps)
    return timers


def time_against_library(kernel, lib, device: bool = False) -> dict:
    """One call's times.  ``ms``: the kernel's, the mean of 5 launches
    from the host (CUDA events around them).  Where a library call
    computes the same function, or ``device`` asks for the card-alone
    time: ``ALT_ROUNDS`` rounds, each timing the kernel from the host as
    ``ms`` and on the card alone (``graph_replay_ms``: a few
    microseconds of kernel can hide under tens of microseconds of the
    wrapper's host work), and the library call the same ways in turns
    with it (``library_ms`` first, alone); the medians of the rounds are
    ``alt_ms``, ``device_ms`` and, with a library call,
    ``alt_library_ms`` and ``library_device_ms``."""
    import statistics

    out = {"ms": cuda_ms(kernel, 5)}
    if lib is None and not device:
        return out
    fns = {"": kernel}
    if lib is not None:
        lib()
        out["library_ms"] = cuda_ms(lib, 5)
        fns["library_"] = lib
    timers = dict(zip(fns, graph_replay_ms(list(fns.values()))))
    runs = {}
    for _ in range(ALT_ROUNDS):
        for key, fn in fns.items():
            runs.setdefault(f"alt_{key}ms", []).append(cuda_ms(fn, 5))
            runs.setdefault(f"{key}device_ms", []).append(timers[key]())
    out.update({k: statistics.median(v) for k, v in runs.items()})
    return out


def compare_kernels(calls, fns, groups, budget_s) -> dict:
    """Each recorded call through the kernel, and the first call of
    each group (``groups[name][i]``) — then further calls while the
    kernel's plain total stays under ``budget_s`` — through the plain
    version too, bit for bit.  Also
    the bytes, operations and bound of every call, and the library
    call's time where there is one."""
    import torch

    results = {}
    for name, recorded in calls.items():
        if not recorded:
            raise RuntimeError(f"the main path made no {name} call")
        fn = fns[name]
        err, ms, ms_all, plain_ms, shapes, compared = 0, 0.0, 0.0, 0.0, [], []
        nbytes = nops = iface_bytes = 0
        bound_s = bytes_s = ops_s = 0.0
        lib_times = {}
        seen = set()
        # Warm-up: both versions on the first recorded call.
        args, kw = recorded[0]
        fn(*args, **{**kw, "kernel": "cuda"})
        fn(*args, **{**kw, "kernel": "torch"})
        torch.cuda.synchronize()
        for idx, (args, kw) in enumerate(recorded):
            got = fn(*args, **{**kw, "kernel": "cuda"})
            t = time_against_library(
                lambda: fn(*args, **{**kw, "kernel": "cuda"}), library_call(name, args),
                device=name in DEVICE_TIMED,
            )
            k_ms = t.pop("ms")
            ms_all += k_ms
            for key, v in t.items():
                lib_times[key] = lib_times.get(key, 0.0) + v
            got = got if isinstance(got, tuple) else (got,)
            shapes.append(list(got[0].shape))
            b, o = call_work(name, args, got)
            nbytes, nops = nbytes + b, nops + o
            iface_bytes += interface_bytes(name, args, b)
            bytes_s, ops_s = bytes_s + b / HBM_BYTES_PER_S, ops_s + o / INT32_OPS_PER_S
            bound_s += max(b / HBM_BYTES_PER_S, o / INT32_OPS_PER_S)
            group = groups[name][idx]
            if group in seen and plain_ms / 1e3 >= budget_s:
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
            "calls": len(recorded), "groups": len(set(groups[name])),
            "compared_calls": compared, "shapes": shapes,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "ms_all_calls": ms_all, "bytes": nbytes, "int_ops": nops,
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "library_ms": lib_times.get("library_ms"),
            "bound_share": bound_s * 1e3 / ms_all if ms_all else None,
        }
        if iface_bytes != nbytes:
            # what the interface makes the kernel write besides (the
            # zeros of samples past n): the least time with them
            results[name]["interface_bytes"] = iface_bytes
            results[name]["interface_bound_ms"] = iface_bytes / HBM_BYTES_PER_S * 1e3
        if lib_times:
            # from the rounds in turns; a ratio > 1: the kernel is faster
            results[name].update(lib_times)
            results[name]["device_bound_share"] = bound_s * 1e3 / lib_times["device_ms"]
        if "alt_library_ms" in lib_times:
            results[name]["library_over_kernel"] = lib_times["alt_library_ms"] / lib_times["alt_ms"]
            results[name]["library_over_kernel_device"] = (
                lib_times["library_device_ms"] / lib_times["device_ms"])
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
        [r.bits_per_sample for r in files], config=config, device=DEVICE,
    )
    return [o.getvalue() for o in outs]


def record_enc_calls(decoded, names):
    """Phase 4's recording run: {kernel: [(args, kwargs), ...]} as the
    pooled encode called the wrappers, each call's format group (one
    ``encode_frames_device`` run per group), and per chunk the host prep
    and the payloads the production packer wrote, in dispatch order."""
    import alacnet_tpu_torch

    calls = {k: [] for k in ENC_CALL_SITES}
    groups = {k: [] for k in ENC_CALL_SITES}
    chunks = []
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

    def packed(key, orig):
        def run(prep, fetch, timings):
            payloads = orig(prep, fetch, timings)
            chunks.append((prep, payloads))
            return payloads
        return run

    with wrapped(ENC_CALL_SITES, make), wrapped(ENCODE_DEVICE, per_group), \
            wrapped(ENC_PACK, packed):
        encode_pooled(decoded, names, alacnet_tpu_torch.EncoderConfig())
    if len(chunks) != len(calls["enc_rice"]):
        raise RuntimeError(f"{len(chunks)} packed chunks, "
                           f"{len(calls['enc_rice'])} rice_merge_fused calls")
    return calls, groups, chunks


def run_symbol_route(rice_calls, chunks) -> dict:
    """Phase 6's route run: each chunk's Rice-stage inputs through
    ``rice_symbols_fused`` on the card, the planes through the native
    symbol packer; the payloads must equal the production encoder's."""
    import torch

    from alacnet_tpu_torch.codec.encoder_device import pack_symbol_planes
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.cuda.rice_emit import rice_symbols_fused

    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    frames = 0
    for i, ((args, kw), (prep, payloads)) in enumerate(zip(rice_calls, chunks)):
        if prep["extra_plane"] is not None:
            raise RuntimeError(f"chunk {i} has an extra-bits plane")
        v16, v32, widths, bad = rice_symbols_fused(*args, **kw)
        if bool(bad.any()):
            raise RuntimeError(f"chunk {i}: the emitter desynced")
        got = pack_symbol_planes(prep, v16.cpu().numpy(), v32.cpu().numpy(),
                                 widths.cpu().numpy())
        if got != payloads:
            diff = next(f for f, (a, b) in enumerate(zip(got, payloads)) if a != b)
            raise RuntimeError(f"chunk {i}: symbol-route payload of frame {diff} "
                               "differs from the production encoder's")
        frames += len(payloads)
    out = {"chunks": len(chunks), "frames": frames, "wall_s": time.perf_counter() - t0,
           "launches": dict(_lib.LAUNCHES)}
    if out["launches"].get("rice_emit", 0) == 0:
        raise RuntimeError("the symbol-plane route launched no rice_emit kernel")
    emit({"symbol_route": out})
    return out


def enc_fns() -> dict:
    from alacnet_tpu_torch.ops.cuda import enc_stages, rice_emit

    return {
        "enc_pred": enc_stages.predictor_errors_fused,
        "enc_rice": enc_stages.rice_merge_fused,
        "rice_emit": rice_emit.rice_symbols_fused,
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


def expected_sha(pcm, want) -> str:
    """sha256 of ``pcm`` as expected.json hashes it (its dtype, little
    endian)."""
    return hashlib.sha256(
        pcm.astype(np.dtype(want["dtype"]).newbyteorder("<")).tobytes()
    ).hexdigest()


def check_session_api(names, data, decoded, expected, enc_expected) -> dict:
    """Phase 7's checks: the session, streaming, resumable and CLI entry
    points on the card against expected.json / encode_expected.json."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch import cli
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.pcm import format_pcm_bytes, read_wav

    _lib.reset_launches()
    hits = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for name in names:
            want, pcm = expected[name], decoded[name].pcm
            with at.AlacContext(io.BytesIO(data[name]), window=API_WINDOW,
                                device=DEVICE) as ctx:
                got = ctx.read_all()
            hits[name] = ctx.prefetch_hits
            if expected_sha(got, want) != want["sha256"] or ctx.prefetch_hits < 1:
                raise RuntimeError(f"AlacContext on {name}: PCM differs from "
                                   f"expected.json or no readahead ({ctx.prefetch_hits})")
            with at.ALACFileReader(io.BytesIO(data[name]), device=DEVICE) as r:
                ba = r.wave_format.block_align
                r.position = r.length // 2
                tail = b"".join(iter(lambda: r.read(65536), b""))
            ref = format_pcm_bytes(pcm, r.wave_format.bits_per_sample // 8)
            if tail != ref[(r.length // 2 // ba) * ba :]:
                raise RuntimeError(f"ALACFileReader on {name}: the tail after a seek "
                                   "to the middle differs")
            path = tmp / name
            path.write_bytes(data[name])
            cursor, parts = at.DecodeCursor(str(path)), []
            while not cursor.done:
                part, cursor = at.decode_resumable(cursor, max_frames=RESUME_FRAMES,
                                                   device=DEVICE)
                parts.append(part.pcm)
            if expected_sha(np.concatenate(parts), want) != want["sha256"]:
                raise RuntimeError(f"decode_resumable on {name} differs from expected.json")
        api_launches = dict(_lib.LAUNCHES)
        if api_launches.get("rice_lpc", 0) == 0:
            raise RuntimeError("the session API launched no rice_lpc kernel")

        m4as = [str(tmp / n) for n in names]
        with contextlib.redirect_stdout(io.StringIO()) as said:
            if cli.main(["batch-decode", *m4as, "--out-dir", str(tmp / "wav"),
                         "--device", DEVICE]) != 0:
                raise RuntimeError("cli batch-decode failed")
            wavs = []
            for name in names:
                wav = tmp / "wav" / (pathlib.Path(name).stem + ".wav")
                with open(wav, "rb") as f:
                    pcm, _, _ = read_wav(f)
                if expected_sha(pcm, expected[name]) != expected[name]["sha256"]:
                    raise RuntimeError(f"cli batch-decode: {wav.name} differs")
                wavs.append(str(wav))
            for m4a in m4as:
                if cli.main(["verify", m4a, "--device", DEVICE]) != 0:
                    raise RuntimeError(f"cli verify {m4a} failed")
            if cli.main(["batch-encode", *wavs, "--out-dir", str(tmp / "m4a"),
                         "--device", DEVICE]) != 0:
                raise RuntimeError("cli batch-encode failed")
            (tmp / "one").mkdir()
            for wav, name in zip(wavs, names):
                if cli.main(["encode", wav, str(tmp / "one" / name)]) != 0:
                    raise RuntimeError(f"cli encode {wav} failed")
        for name in names:
            want = enc_expected[f"{name}|default"]["sha256"]
            for cmd, out in (("batch-encode", tmp / "m4a" / name), ("encode", tmp / "one" / name)):
                if hashlib.sha256(out.read_bytes()).hexdigest() != want:
                    raise RuntimeError(f"cli {cmd}: {name} differs from encode_expected.json")
    out = {"files": len(names), "prefetch_hits": hits, "launches": api_launches,
           "cli_lines": said.getvalue().splitlines()}
    emit({"session_api": out})
    return out


def long_stream(music) -> tuple:
    """The session API's long stream: the music file's PCM tiled
    LONG_COPIES times, encoded by the port; returns (pcm, .m4a bytes)."""
    import alacnet_tpu_torch as at

    pcm = np.tile(music.pcm, (LONG_COPIES, 1))
    buf = io.BytesIO()
    at.encode_files([pcm], [buf], music.sample_rate, music.bits_per_sample,
                    device=DEVICE)
    return pcm, buf.getvalue()


def time_session_api(decoded, card: str) -> dict:
    """The session API's read rate over the long stream."""
    import torch

    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.pcm import format_pcm_bytes

    music = decoded["music.m4a"]
    pcm, data = long_stream(music)
    samples = pcm.shape[0]
    ref = format_pcm_bytes(pcm, music.bits_per_sample // 8)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with at.AlacContext(io.BytesIO(data), device=DEVICE) as ctx:
        got = ctx.read_all()
        frames, window, hits = ctx.num_frames, ctx._window, ctx.prefetch_hits
    ctx_s = time.perf_counter() - t0
    if not np.array_equal(got, pcm):
        raise RuntimeError("AlacContext on the long stream differs")
    t0 = time.perf_counter()
    with at.ALACFileReader(io.BytesIO(data), device=DEVICE) as r:
        body = b"".join(iter(lambda: r.read(65536), b""))
    reader_s = time.perf_counter() - t0
    if body != ref:
        raise RuntimeError("ALACFileReader on the long stream differs")
    out = {
        "frames": frames, "samples": samples, "window": window,
        "prefetch_hits": hits,
        "context_read_all_s": ctx_s, "context_msamples_per_s": samples / ctx_s / 1e6,
        "reader_read_65536_s": reader_s,
        "reader_msamples_per_s": samples / reader_s / 1e6,
        "rice_lpc_pass": time_session_passes(data), "card": card,
    }
    emit({"session_api_rate": out})
    return out


def record_session_calls(data: bytes) -> list:
    """Every ``rice_lpc`` call, as (args, kwargs), of one
    ``AlacContext.read_all`` of ``data`` (two passes a window)."""
    import alacnet_tpu_torch as at

    calls = []

    def make(key, orig):
        def rec(*args, **kwargs):
            calls.append((args, kwargs))
            return orig(*args, **kwargs)
        return rec

    with wrapped({"rice_lpc": CALL_SITES["rice_lpc"]}, make):
        with at.AlacContext(io.BytesIO(data), device=DEVICE) as ctx:
            ctx.read_all()
    return calls


def time_session_passes(data: bytes) -> dict:
    """``rice_lpc``'s time per pass at the session shape: each recorded
    call (``record_session_calls``) through the kernel again (CUDA
    events, the mean of 5 launches after a warm-up)."""
    import statistics

    calls = record_session_calls(data)
    fn = decode_fns()["rice_lpc"]
    ms = []
    for args, kw in calls:
        run = lambda: fn(*args, **{**kw, "kernel": "cuda"})  # noqa: E731
        run()
        ms.append(cuda_ms(run, 5))
    return {"passes": len(calls), "lanes": sorted({a[0].shape[0] for a, _ in calls}),
            "mean_ms": statistics.fmean(ms), "median_ms": statistics.median(ms),
            "max_ms": max(ms), "sum_ms": sum(ms)}


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

    smi = nvidia_smi()
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
    emit({"phase": 1, "seconds": time.perf_counter() - t0})

    t = time.perf_counter()
    calls, groups = record_calls(names, data, config)
    checks = compare_kernels(calls, decode_fns(), groups, PLAIN_BUDGET_S)
    del calls
    torch.cuda.empty_cache()
    emit({"phase": 2, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    e2e, decoded = run_e2e(names, data, expected, config, smi)
    enc_expected = json.loads((CORPUS / "encode_expected.json").read_text())
    emit({"phase": 3, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    calls, groups, chunks = record_enc_calls(decoded, names)
    rice_calls = calls["enc_rice"]
    checks.update(compare_kernels(calls, enc_fns(), groups, PLAIN_BUDGET_S))
    del calls
    torch.cuda.empty_cache()
    emit({"phase": 4, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    enc = run_encode_e2e(decoded, names, expected, enc_expected, smi)
    emit({"phase": 5, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    route = run_symbol_route(rice_calls, chunks)
    del chunks
    checks.update(compare_kernels({"rice_emit": rice_calls}, enc_fns(),
                                  {"rice_emit": groups["enc_rice"]}, PLAIN_BUDGET_S))
    del rice_calls
    torch.cuda.empty_cache()
    emit({"phase": 6, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    check_session_api(names, data, decoded, expected, enc_expected)
    time_session_api(decoded, smi)
    emit({"phase": 7, "seconds": time.perf_counter() - t})

    launches = {**e2e["launches"], **enc["launches"], **route["launches"]}
    kernels = [
        {"name": k, "route": "cuda", "source": f"alacnet_tpu_torch/csrc/{k}.cu",
         "replaces": KERNELS[k], "path": KERNEL_PATHS[k], "launches": launches[k],
         "max_abs_err": checks[k]["max_abs_err"], "calls": checks[k]["calls"],
         "plain_calls": len(checks[k]["compared_calls"]),
         "ms": checks[k]["ms_all_calls"], "device_ms": checks[k].get("device_ms"),
         "plain_ms": checks[k]["plain_ms"],
         "bytes": checks[k]["bytes"], "int_ops": checks[k]["int_ops"],
         "bound_ms": checks[k]["bound_ms"], "bound_by": checks[k]["bound_by"],
         "library_ms": checks[k]["library_ms"]}
        for k in KERNELS
    ]
    emit({"kernels": kernels})
    emit({"total_seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
