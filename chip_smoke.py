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
   ``read_all``, each through the kernel again, CUDA events);
8. bench — ``alacnet_tpu_torch.bench_lib.run_full_benchmark`` on the card
   at the bench's own frame counts (the e2e decode to host PCM and the
   sink decode over 12,288 mixed frames, each kind's device stage over
   4,096 frames, the encode over 2,048), at its default runs (5 behind
   every median, ``bench_lib.MIN_REPEATS``), with the e2e profiler run's
   Chrome trace (``capture_trace``) written to a temporary directory;
   its record goes on a ``bench`` line.  It fails unless ``parity_ok``
   holds, every headline is above 0, the e2e device-busy share is a
   measured number, the trace names the ``rice_lpc`` kernel and each
   kernel of the bench's paths (all but ``rice_emit``) launched;
9. mesh — data parallelism over frames (``parallel/mesh.py``,
   ``parallel/distributed.py``): the pooled smoke decode through
   ``decode_streams(mesh=)`` over every visible card and over two shards
   on the first card (``TWO_SHARDS``: two streams), each against
   ``expected.json``, with every launch's stream recorded (``_lib.launch``
   wrapped): under two shards each decode kernel must launch on both shard
   streams and on no other; ``encode_files(mesh=)`` of each smoke file's
   PCM over the two shards against ``encode_expected.json`` (both encode
   kernels on both streams) and ``encode_frames_device(mesh=)`` of a
   ragged slice of music.m4a's PCM against the single device and the
   host encoder; every call the two-shard decode and encode made to the
   five kernel wrappers, recorded with its stream, and the first on each
   shard stream — then more while the kernel's plain total stays under
   ``MESH_PLAIN_BUDGET_S`` — run again on that stream through the
   kernel and the plain version, bit for bit (``mesh_kernel_check``
   lines); the port's ``dryrun_multichip(2, TWO_SHARDS)``; the
   distributed decode in worker subprocesses (this script with
   ``--dist-worker``), world 1 on ``nccl`` and world 2 on ``gloo``, both
   ranks on the first card, every worker under a timeout, their PCM in
   rank order against music.m4a's x ``DIST_COPIES`` and the all-reduced
   total and checksum against it; then ``decode_blob``'s rate to host PCM
   over the bench's mixed pool without a mesh, over a one-card mesh and
   over two shards, in turns (``MESH_RATE_RUNS`` each), printed beside the
   card's name and power limit, with the quartiles of each arm's runs.
   The ``kernels`` line's ``mesh_launches`` are the two-shard decode's
   and encode's counts, ``mesh_max_abs_err`` and ``mesh_plain_calls``
   (calls compared, per shard stream) their kernel checks';
10. encoder routes — phase 4's pooled ``encode_files(device="cuda")``
   run on each packing route (``ROUTES``: the default host pair pack,
   ``pack="scatter"``, ``pack="gather"``, ``quads=True``), first one
   checked round (every output's sha256 against ``encode_expected.json``,
   ``enc_pred`` and ``enc_rice`` launched, every chunk device-packed on
   the device routes, some chunk on quads), then ``ROUTE_RUNS`` timed
   rounds in turns, the order rotating; hires24 and fat24 with
   ``EncoderConfig(uncompressed_bytes=1)`` under ``pack="scatter"`` (the
   host packer, their hashes); seven 16-bit music frames and one of
   full-range noise with quads (a minority repacked, equal to the host
   ``AlacEncoder``); then one 1,024-frame chunk of music.m4a's PCM: the
   gather and scatter packs and the quad fold timed by CUDA events,
   every route's bytes against the host packer's, and what each route
   copies back.  It prints the chunks on quads, the frames repacked,
   each route's rate (median of the timed rounds) over the pair
   route's, and the D2H bytes per sample, beside the card's name and
   power limit.  The ``kernels`` line's ``route_launches`` are each
   route's checked-run counts;
11. soak, fuzz, route variables — (a) ``scripts/soak_torch.run_soak``
   at ``SOAK_MINUTES`` (six formats, 32,040,000 samples): every file's
   ``encode_m4a(device="cuda")`` bytes against the host encoder's, the
   pooled ``decode_files`` bit-exact per file, the encode and decode
   walls and rates; ``pack_rows``, ``rice_lpc``, ``bulk_bits``,
   ``enc_pred`` and ``enc_rice`` must launch (counts set to 0 just
   before, read just after: the ``kernels`` line's ``soak_launches``);
   each wrapper call of the soak is recorded and, after it, run again
   through the kernel and the plain version, bit for bit: the first call
   of each group (a decode batch's formats and order bucket, an encode
   file), then the rest, while the kernel's plain total stays under
   ``SOAK_PLAIN_BUDGET_S`` (``soak_kernel_check`` lines; every kernel
   compared at least once; the ``kernels`` line's ``soak_max_abs_err``
   and ``soak_plain_calls``); (b) the fuzz batches (1,536 16-bit and
   768 24-bit frames of 64 samples, seeds 101 and 202) through
   ``decode_frames`` with ``kernel="cuda"`` and ``kernel="torch"``, lane
   by lane: lanes whose cursor (the decode's own) leaves its word row on
   either route are counted and printed, every other lane must be equal
   (``soak_torch.fuzz_routes``); (c) music.m4a's PCM encoded once under
   each of ``ROUTE_VARS`` (``ALAC_ENC_PAIR=0``, ``ALAC_ENC_QUAD=1``,
   ``ALAC_ENC_DEVICE_PACK=1`` with either ``ALAC_ENC_PACK_IMPL``), its
   bytes against ``encode_expected.json`` and the packer that ran
   against the variable's.  Before phase 1 the script removes every
   ``ALAC_*`` variable the port reads (``PORT_ENV``) and prints the ones
   it removed, so phases 1-10 run the defaults.

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
#: The kernels the bench's paths launch (rice_emit is on no encoder path).
BENCH_KERNELS = DECODE_KERNELS + ENCODE_KERNELS
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


def max_abs_err(name: str, got, want) -> int:
    """The largest |kernel - plain| over a call's outputs (each a tensor
    or a tuple of them); raises where a shape or dtype differs."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, (g.to(torch.int64) - w.to(torch.int64)).abs().max().item())
    return err


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
            err = max(err, max_abs_err(name, got, plain[0]))
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


def pcm_sha(pcm) -> str:
    return hashlib.sha256(pcm.astype(pcm.dtype.newbyteorder("<")).tobytes()).hexdigest()


def check_pooled(results, names, expected, what: str) -> None:
    """Each pooled result (COPIES per file, in ``names`` order) against
    expected.json's sha256 and shape."""
    for i, r in enumerate(results):
        name = names[i // COPIES]
        if pcm_sha(r.pcm) != expected[name]["sha256"] or list(r.pcm.shape) != expected[name]["shape"]:
            raise RuntimeError(f"{what}: PCM of {name} (copy {i % COPIES}) differs from expected.json")


def run_e2e(names, data, expected, config, card: str):
    """Phase 3.  Returns the e2e numbers and one decoded copy per file."""
    import torch

    import alacnet_tpu_torch
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.utils.observability import GLOBAL_STATS, profile_busy

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

    check_pooled(results, names, expected, "decode_streams")
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


def encode_pooled(decoded, names, config, **route) -> list[bytes]:
    """``encode_files(device="cuda", **route)`` on each file's PCM,
    COPIES times over, pooled; the output bytes in input order."""
    import alacnet_tpu_torch

    files = [decoded[n] for n in names for _ in range(COPIES)]
    outs = [io.BytesIO() for _ in files]
    alacnet_tpu_torch.encode_files(
        [r.pcm for r in files], outs, [r.sample_rate for r in files],
        [r.bits_per_sample for r in files], config=config, device=DEVICE, **route,
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


def check_hashes(datas, names, cfg_name, enc_expected, what: str) -> None:
    """Every pooled output (COPIES per file) against encode_expected.json."""
    for i, d in enumerate(datas):
        name = names[i // COPIES]
        want = enc_expected[f"{name}|{cfg_name}"]
        if len(d) != want["bytes"] or hashlib.sha256(d).hexdigest() != want["sha256"]:
            raise RuntimeError(f"{what}{name} ({cfg_name}, copy {i % COPIES}) differs "
                               "from encode_expected.json")


def check_encoded(datas, names, decoded, cfg_name, config, enc_expected, expected):
    """Every output against encode_expected.json; one copy per file
    against the port's host encoder; every output decoded on the card
    back to expected.json's PCM."""
    import alacnet_tpu_torch

    check_hashes(datas, names, cfg_name, enc_expected, "")
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
    from alacnet_tpu_torch.utils.observability import profile_busy

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


def run_bench() -> dict:
    """Phase 8: the port's bench on the card, its record checked."""
    import torch

    from alacnet_tpu_torch import bench_lib
    from alacnet_tpu_torch.ops.cuda import _lib

    torch.cuda.synchronize()
    _lib.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        rec = bench_lib.run_full_benchmark(trace_dir=tmp)
        launches = dict(_lib.LAUNCHES)
        trace = rec["e2e_trace_file"]
        trace_text = pathlib.Path(trace).read_text() if trace else ""
    emit({"bench": rec})
    emit({"bench_summary": bench_lib.summary(rec)})
    if not rec["parity_ok"]:
        raise RuntimeError(f"the bench's lossless gate failed: {rec['parity_by_part']}")
    headlines = {
        "value": rec["value"], "e2e_sink_msamples_per_s": rec["e2e_sink_msamples_per_s"],
        "e2e_stage_bound_msps": rec["e2e_stage_bound_msps"],
        **{f"device_msps_by_kind.{k}": v for k, v in rec["device_msps_by_kind"].items()},
        **{k: rec[k] for k in ("encode_msps", "encode_wall_msps", "encode_device_msps",
                               "encode_devpack_device_msps", "encode_devpack_scatter_msps")},
    }
    low = {k: v for k, v in headlines.items() if not (isinstance(v, float) and v > 0)}
    if low or len(rec["device_msps_by_kind"]) != len(bench_lib.CORPUS_KINDS):
        raise RuntimeError(f"bench headlines not above 0: {low}")
    if "encode_devpack_error" in rec:
        raise RuntimeError(f"the bench's device pack failed: {rec['encode_devpack_error']}")
    busy = rec["e2e_device_busy_share"]
    if not (isinstance(busy, float) and busy > 0):
        raise RuntimeError(f"the e2e device-busy share is not measured: {busy!r}")
    if "rice_lpc" not in trace_text:
        raise RuntimeError(f"the capture_trace run's trace ({trace}) names no rice_lpc")
    missing = [k for k in BENCH_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"the bench launched no {missing} kernel")
    return {"launches": launches, "trace_bytes": len(trace_text)}


#: The two-shard mesh of phase 9: two streams on the first card.
TWO_SHARDS = ("cuda:0", "cuda:0")
#: Copies of music.m4a's frames the distributed workers decode between them.
DIST_COPIES = 5
#: Seconds a distributed worker may take (its rendezvous times out first).
DIST_TIMEOUT_S = 240
DIST_INIT_TIMEOUT_S = 120
#: The distributed runs of phase 9: (backend, world size); NCCL refuses
#: two ranks on one card, so the two-rank run uses gloo.
DIST_RUNS = (("nccl", 1), ("gloo", 2))
#: Runs of each arm behind phase 9's decode_blob rates, in turns, over
#: the bench's mixed pool (its 4096-sample frames, run_e2e_benchmark's
#: 12,288 of them).
MESH_RATE_RUNS = 9
MESH_RATE_FRAMES = 3 * 4096
#: Where the kernel wrappers launch: phase 9 records each launch's stream.
LAUNCH_SITE = {"launch": ("alacnet_tpu_torch.ops.cuda._lib", "launch")}
#: Where the two-shard path calls each kernel wrapper: each shard cuts
#: its own rows in parallel/mesh.py, and decodes and encodes as on one
#: device.
MESH_CALL_SITES = {
    **CALL_SITES, "pack_rows": ("alacnet_tpu_torch.parallel.mesh", "pack_rows"),
    **ENC_CALL_SITES,
}
#: Seconds of plain-version runs each kernel's phase-9 check may spend
#: past the first call on each shard stream (the plain rice_lpc and
#: predictor take ~10-13 s a call on the H100, so those two stop there).
MESH_PLAIN_BUDGET_S = 8.0


def stream_recorder(seen):
    """A ``wrapped`` factory for ``_lib.launch``: counts (kernel, raw
    stream handle) of every launch."""
    import torch

    def make(key, orig):
        def rec(name, device, *args):
            index = device.index if device.index is not None else torch.cuda.current_device()
            key = (name.removeprefix("alac_"), torch._C._cuda_getCurrentRawStream(index))
            seen[key] = seen.get(key, 0) + 1
            return orig(name, device, *args)
        return rec
    return make


def shard_recorder(calls):
    """A ``wrapped`` factory for the kernel wrappers' call sites: appends
    each call to ``calls[kernel]`` as (args, kwargs, the stream it was
    queued on)."""
    import torch

    def make(key, orig):
        def rec(*args, **kwargs):
            stream = torch.cuda.current_stream(args[0].device)
            calls.setdefault(key, []).append((args, kwargs, stream))
            return orig(*args, **kwargs)
        return rec
    return make


def compare_shard_calls(calls, fns, streams, budget_s) -> dict:
    """Phase 9's kernel checks: the calls the two-shard path made
    (``shard_recorder``), each run again on the shard stream it was
    queued on, through the kernel and through the plain version, bit for
    bit: the first call on each shard stream, then further calls while
    the kernel's plain total stays under ``budget_s``.  Fails unless
    every kernel was compared on every shard stream."""
    import torch

    handles = [s.cuda_stream for s in streams]
    torch.cuda.synchronize()
    results = {}
    for name, recorded in calls.items():
        fn = fns[name]
        err, plain_ms, compared, shapes = 0, 0.0, [], []
        by_stream = [0] * len(streams)
        for idx, (args, kw, stream) in enumerate(recorded):
            i = handles.index(stream.cuda_stream)
            if by_stream[i] and plain_ms / 1e3 >= budget_s:
                continue
            plain = []
            with torch.cuda.stream(streams[i]):
                got = fn(*args, **{**kw, "kernel": "cuda"})
                plain_ms += cuda_ms(
                    lambda: plain.append(fn(*args, **{**kw, "kernel": "torch"})), 1
                )
                err = max(err, max_abs_err(name, got, plain[0]))
            by_stream[i] += 1
            compared.append(idx)
            shapes.append(list((got if isinstance(got, tuple) else (got,))[0].shape))
        if err != 0:  # the tolerance: bit for bit
            raise RuntimeError(f"{name} on a shard stream: kernel differs from plain, "
                               f"max |err| {err}")
        if 0 in by_stream:
            raise RuntimeError(f"{name}: no call compared on a shard stream: {by_stream}")
        results[name] = {"calls": len(recorded), "compared_calls": compared,
                         "compared_by_stream": by_stream, "shapes": shapes,
                         "max_abs_err": err, "plain_ms": plain_ms}
        emit({"mesh_kernel_check": name, **results[name]})
    return results


def mesh_decode(names, data, expected, mesh, calls) -> dict:
    """Phase 9's decodes: the pooled smoke corpus through
    ``decode_streams(mesh=)`` over every visible card and over the two
    shards of ``mesh``, each against expected.json; under two shards,
    every decode kernel must launch on both shard streams, and each
    wrapper call is appended to ``calls`` (``shard_recorder``)."""
    import torch

    import alacnet_tpu_torch
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for label, mesh in (("all_cards", make_mesh()), ("two_shards", mesh)):
        seen: dict = {}
        sites = {} if label == "all_cards" else {k: MESH_CALL_SITES[k] for k in DECODE_KERNELS}
        torch.cuda.synchronize()
        _lib.reset_launches()
        with wrapped(LAUNCH_SITE, stream_recorder(seen)), \
                wrapped(sites, shard_recorder(calls)):
            t0 = time.perf_counter()
            results = alacnet_tpu_torch.decode_streams(pooled_streams(names, data), mesh=mesh)
            wall = time.perf_counter() - t0
        launches = dict(_lib.LAUNCHES)
        check_pooled(results, names, expected, f"decode_streams({mesh})")
        del results
        handles = [s.cuda_stream for s in mesh.streams]
        by_stream = {k: [seen.get((k, h), 0) for h in handles] for k in DECODE_KERNELS}
        idle = {k: c for k, c in by_stream.items() if 0 in c}
        if idle or {h for _, h in seen} - set(handles):
            raise RuntimeError(f"decode_streams({mesh}): kernels off the shard streams "
                               f"or idle on one: {by_stream}, {seen}")
        out[label] = {"mesh": repr(mesh), "wall_s": wall, "launches": launches,
                      "launches_by_stream": by_stream}
    return out


def mesh_encode(names, decoded, enc_expected, mesh, calls) -> dict:
    """Phase 9's encodes over the two shards of ``mesh``:
    ``encode_files(mesh=)`` of each smoke file's PCM against
    encode_expected.json, each encode wrapper call appended to ``calls``
    (``shard_recorder``), and ``encode_frames_device(mesh=)`` of a ragged
    slice (a partial frame, an odd count) against the single device and
    the host encoder."""
    import torch

    import alacnet_tpu_torch
    from alacnet_tpu_torch.codec.encoder_device import encode_frames_device
    from alacnet_tpu_torch.ops.cuda import _lib

    seen: dict = {}
    files = [decoded[n] for n in names]
    outs = [io.BytesIO() for _ in files]
    sites = {k: MESH_CALL_SITES[k] for k in ENCODE_KERNELS}
    torch.cuda.synchronize()
    _lib.reset_launches()
    with wrapped(LAUNCH_SITE, stream_recorder(seen)), wrapped(sites, shard_recorder(calls)):
        alacnet_tpu_torch.encode_files(
            [r.pcm for r in files], outs, [r.sample_rate for r in files],
            [r.bits_per_sample for r in files], mesh=mesh,
        )
    launches = dict(_lib.LAUNCHES)
    for name, o in zip(names, outs):
        want = enc_expected[f"{name}|default"]
        if hashlib.sha256(o.getvalue()).hexdigest() != want["sha256"]:
            raise RuntimeError(f"encode_files(mesh=): {name} differs from encode_expected.json")
    handles = [s.cuda_stream for s in mesh.streams]
    by_stream = {k: [seen.get((k, h), 0) for h in handles] for k in ENCODE_KERNELS}
    if any(0 in c for c in by_stream.values()):
        raise RuntimeError(f"encode_files(mesh=): an encode kernel idle on a shard: {by_stream}")

    music = decoded["music.m4a"]
    S = 4096
    frames = [music.pcm[i : i + S] for i in range(0, music.pcm.shape[0], S)][:11]
    frames[4] = frames[4][:1234]
    params = alacnet_tpu_torch.default_cookie(music.sample_rate, 16, 2, S)
    single = encode_frames_device(frames, params, device=DEVICE)
    meshed = encode_frames_device(frames, params, mesh=mesh)
    host = alacnet_tpu_torch.AlacEncoder(params)
    if meshed != single or single != [host.encode_frame(f) for f in frames]:
        raise RuntimeError("encode_frames_device(mesh=) differs from the single device "
                           "or the host encoder on the ragged slice")
    return {"files": len(files), "launches": launches, "launches_by_stream": by_stream,
            "ragged_frames": len(frames)}


def mesh_rates(card: str) -> dict:
    """``decode_blob`` to host PCM over the bench's mixed pool (12,288
    frames, a fresh order each run), without a mesh, over a one-card
    mesh and over two shards on one card, in turns (the arms' order
    rotating every round); every run's PCM held against its source.
    Host clock around each call; medians."""
    import statistics

    import torch

    from alacnet_tpu_torch import bench_lib
    from alacnet_tpu_torch.config import DecodeConfig
    from alacnet_tpu_torch.parallel.mesh import make_mesh
    from alacnet_tpu_torch.parallel.pipeline import decode_blob

    S, total_frames = 4096, MESH_RATE_FRAMES
    pool, frames, params = bench_lib._mixed_pool_frames(S, 16)
    table, lengths = bench_lib._source_table(frames, S)
    rng = np.random.default_rng(7)
    config = DecodeConfig(device=DEVICE)
    arms = {"no_mesh": None, "one_card": make_mesh(TWO_SHARDS[:1]),
            "two_shards": make_mesh(TWO_SHARDS)}
    walls = {k: [] for k in arms}
    samples = None
    order = list(arms.items())
    for r in range(MESH_RATE_RUNS + 1):  # the first round warms up
        for label, mesh in order[r % 3:] + order[: r % 3]:  # each arm first in turn
            src = rng.permutation(
                np.repeat(np.arange(len(pool)), -(-total_frames // len(pool)))[:total_frames]
            )
            blob, offsets, sizes = bench_lib._blob([pool[i] for i in src])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, n, status = decode_blob(blob, offsets, sizes, params, S, config=config, mesh=mesh)
            wall = time.perf_counter() - t0
            if status.any() or not bench_lib._gate_host(out, n, src, table, lengths):
                raise RuntimeError(f"decode_blob ({label}): PCM differs from the source")
            samples = int(n.sum())
            del out
            if r:
                walls[label].append(wall)
    rates = {}
    for label, w in walls.items():
        runs = [samples / x / 1e6 for x in w]
        rates[label] = {"msamples_per_s": samples / statistics.median(w) / 1e6,
                        "quartiles_msps": statistics.quantiles(runs, n=4)[::2],
                        "runs_msps": runs}
    rec = {"frames": total_frames, "samples": samples, "runs": MESH_RATE_RUNS,
           "rates": rates, "card": card}
    emit({"mesh_rates": rec})
    return rec


def dist_worker(init: str, world: int, rank: int, backend: str, device: str,
                out_dir: str) -> int:
    """One rank of phase 9's distributed decode (``--dist-worker``):
    music.m4a's frames x DIST_COPIES split by global frame index, this
    rank's slice decoded on ``device`` through ``decode_frames_global``;
    writes its PCM and prints the global scalars."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed

    import alacnet_tpu_torch.parallel.distributed as dist
    from alacnet_tpu_torch.batch import _collect
    from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu_torch.parallel.pipeline import pad_frame_batch

    dist.initialize(init, world, rank, initialization_timeout=DIST_INIT_TIMEOUT_S,
                    backend=backend)
    try:
        mesh = dist.global_mesh([device])
        info, blob = _collect(io.BytesIO((CORPUS / "music.m4a").read_bytes()))
        offs = info.tables.frame_file_offsets()
        sizes = info.tables.frame_byte_sizes
        payloads = [blob[o : o + s].tobytes() for o, s in zip(offs, sizes)] * DIST_COPIES
        parts = np.array_split(np.arange(len(payloads)), world)
        local = [payloads[i] for i in parts[rank]]
        pad_to = -(-max(len(p) for p in parts) // mesh.local.size) * mesh.local.size
        fb = pad_frame_batch(parse_frame_headers_vec(local, info.params), pad_to)
        S = info.params.max_samples_per_frame
        out, n, total, checksum = dist.decode_frames_global(fb, mesh, S)
        pcm, n = dist.local_samples(out, n)
        k = len(local)
        valid = np.arange(S)[None, :] < n[:k, None]
        np.save(pathlib.Path(out_dir) / f"rank{rank}.npy", pcm[:k].reshape(-1, 2)[valid.reshape(-1)])
        print(json.dumps({"rank": rank, "world": world, "backend": backend, "frames": k,
                          "total": total, "checksum": checksum}), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_distributed(decoded) -> list:
    """Phase 9's distributed decodes, every run's workers started at
    once, each with a timeout: the ranks' PCM, in rank order, must equal
    music.m4a's PCM x DIST_COPIES, and every rank must report its
    total and checksum."""
    from alacnet_tpu_torch.parallel.mesh import wrap_int32

    want = np.concatenate([decoded["music.m4a"].pcm] * DIST_COPIES)
    want_ck = wrap_int32(int(want.astype(np.int64).sum()))
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        try:
            for backend, world in DIST_RUNS:
                d = pathlib.Path(tmp) / f"{backend}{world}"
                d.mkdir()
                init = f"127.0.0.1:{free_port()}"
                procs = [subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker", init,
                     str(world), str(rank), backend, TWO_SHARDS[0], str(d)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ) for rank in range(world)]
                runs.append((backend, world, d, procs))
            deadline = time.monotonic() + DIST_TIMEOUT_S
            for backend, world, d, procs in runs:
                for rank, p in enumerate(procs):
                    try:
                        text = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                    except subprocess.TimeoutExpired:
                        raise RuntimeError(f"distributed {backend} x{world}: rank {rank} timed out")
                    if p.returncode != 0:
                        raise RuntimeError(f"distributed {backend} x{world}: rank {rank} "
                                           f"exited {p.returncode}:\n{text[-4000:]}")
                    rec = json.loads(text.strip().splitlines()[-1])
                    if rec["total"] != want.shape[0] or rec["checksum"] != want_ck:
                        raise RuntimeError(f"distributed {backend} x{world}: rank {rank} "
                                           f"scalars {rec}, expected {want.shape[0]}, {want_ck}")
                    records.append(rec)
                got = np.concatenate([np.load(d / f"rank{r}.npy") for r in range(world)])
                if not np.array_equal(got, want):
                    raise RuntimeError(f"distributed {backend} x{world}: PCM differs")
                print(f"distributed {backend} x{world}: OK", flush=True)
        finally:
            for _, _, _, procs in runs:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
    return records


def run_mesh_phase(names, data, decoded, expected, enc_expected, card: str) -> dict:
    """Phase 9: data parallelism over frames."""
    import torch

    from alacnet_tpu_torch.parallel.mesh import dryrun_multichip, make_mesh

    mesh, calls = make_mesh(TWO_SHARDS), {}
    decode = mesh_decode(names, data, expected, mesh, calls)
    encode = mesh_encode(names, decoded, enc_expected, mesh, calls)
    fns = {**decode_fns(), **enc_fns()}
    shard_checks = compare_shard_calls(
        {k: calls.get(k, []) for k in DECODE_KERNELS + ENCODE_KERNELS}, fns, mesh.streams,
        MESH_PLAIN_BUDGET_S)
    del calls
    torch.cuda.empty_cache()
    dryrun = dryrun_multichip(2, TWO_SHARDS)
    distributed = run_distributed(decoded)
    rates = mesh_rates(card)
    rec = {"decode": decode, "encode": encode, "dryrun": dryrun,
           "distributed": distributed, "card": card}
    emit({"mesh": rec})
    return {**rec, "rates": rates, "shard_checks": shard_checks}


#: Phase 10's encoder routes, each run through the pooled encode_files.
ROUTES = {"pair": {}, "scatter": {"pack": "scatter"}, "gather": {"pack": "gather"},
          "quads": {"quads": True}}
#: Timed rounds of phase 10 (each route once a round, the order rotating),
#: after one checked round.
ROUTE_RUNS = 3
#: Frames of phase 10's one-chunk pack timing (the pipeline's chunk).
PACK_CHUNK_FRAMES = 1024


def route_run(decoded, names, config, route: dict) -> tuple:
    """One pooled ``encode_files`` run on ``route``: (outputs, wall s,
    launches, timings summed over its chunks, chunks packed)."""
    import torch

    from alacnet_tpu_torch.ops.cuda import _lib

    timings: dict = {}
    chunks = [0]

    def with_timings(key, orig):
        def run(*args, **kwargs):
            return orig(*args, **{**kwargs, "timings": timings})
        return run

    def count(key, orig):
        def run(*args, **kwargs):
            chunks[0] += 1
            return orig(*args, **kwargs)
        return run

    torch.cuda.synchronize()
    _lib.reset_launches()
    with wrapped(ENCODE_DEVICE, with_timings), wrapped(ENC_PACK, count):
        t0 = time.perf_counter()
        datas = encode_pooled(decoded, names, config, **route)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return datas, wall, dict(_lib.LAUNCHES), timings, chunks[0]


def check_route(label, route, datas, launches, timings, chunks, cfg_name, names,
                enc_expected) -> None:
    """A route run's outputs against encode_expected.json, its encode
    kernels launched, and its chunks packed the way the route says."""
    check_hashes(datas, names, cfg_name, enc_expected, f"route {label}: ")
    idle = [k for k in ENCODE_KERNELS if launches.get(k, 0) == 0]
    if idle:
        raise RuntimeError(f"route {label} launched no {idle} kernel: {launches}")
    devpack = timings.get("device_pack_chunks", 0)
    want = chunks if "pack" in route and cfg_name == "default" else 0
    if devpack != want:
        raise RuntimeError(f"route {label} ({cfg_name}): {devpack} device-packed chunks "
                           f"of {chunks}, expected {want}")
    if "quads" in route and not timings.get("quad_chunks"):
        raise RuntimeError(f"route {label}: no chunk took quads: {timings}")


def time_pack_chunk(decoded) -> dict:
    """The device packers' and the quad fold's time (CUDA events around
    5 calls after a warm-up) for one PACK_CHUNK_FRAMES-frame chunk of
    music.m4a's PCM, tiled; each route's bytes for that chunk against
    the host packer's, and what each copies back."""
    import torch

    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.codec import encoder_device as ed
    from alacnet_tpu_torch.ops.encode import (
        merge_quad_chunks, pack_frames_device, pack_frames_device_scatter,
    )

    music = decoded["music.m4a"]
    S = 4096
    reps = -(-PACK_CHUNK_FRAMES * S // music.pcm.shape[0])
    frames = np.tile(music.pcm, (reps, 1))[: PACK_CHUNK_FRAMES * S].reshape(-1, S, 2)
    params = at.default_cookie(music.sample_rate, 16, 2, S)
    cfg = at.EncoderConfig()
    prep = ed._prep(frames, params, cfg, at.AlacEncoder(params, cfg))
    dev = torch.device(DEVICE)
    F = prep["F"]
    fetch = ed._dispatch(prep, params, cfg, dev, pack="scatter")
    stride = ed._pack_stride(prep, fetch.get(4)[0])
    cols = torch.from_numpy(
        np.stack([prep["ns_f"], prep["stereo_f"], prep["hbits"]]).astype(np.int32)).to(dev)
    args = (*fetch.planes[:4], cols[0], cols[1] != 0, cols[2])
    pairs = ed._dispatch(prep, params, cfg, dev, pairs=True, quads=True)
    fns = {
        "gather": lambda: pack_frames_device(*args, stride_words=stride),
        "scatter": lambda: pack_frames_device_scatter(*args, stride_words=stride),
        "quad_fold": lambda: merge_quad_chunks(*pairs.planes[:4]),
    }
    out = {"frames": F, "samples": F * S, "stride_words": stride}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = cuda_ms(fn, 5)
    want = ed._pack_host(prep, ed._dispatch(prep, params, cfg, dev, pairs=False), None)
    for impl in ("scatter", "gather"):
        f2 = ed._dispatch(prep, params, cfg, dev, pack=impl)
        if ed._pack_device(prep, f2, None) != want:
            raise RuntimeError(f"the {impl} pack of the timed chunk differs from the host's")
        out[f"{impl}_d2h_bytes"] = f2.d2h_bytes
    f2 = ed._dispatch(prep, params, cfg, dev, pairs=True, quads=True)
    if ed._pack(prep, f2, None) != want:
        raise RuntimeError("the quad pack of the timed chunk differs from the host's")
    out["quads_d2h_bytes"] = f2.d2h_bytes
    f2 = ed._dispatch(prep, params, cfg, dev)
    ed._pack(prep, f2, None)
    out["pair_d2h_bytes"] = f2.d2h_bytes
    for k in ("pair", "quads", "scatter", "gather"):
        out[f"{k}_d2h_bytes_per_sample"] = out[f"{k}_d2h_bytes"] / (F * S)
    return out


def quad_repack_batch(card: str) -> dict:
    """Seven frames of 16-bit music and one of full-range noise, encoded
    with quads on the card: a minority of frames is quad-fat and is
    repacked, and the bytes equal the port's host AlacEncoder's."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.bench_lib import _music_pcm
    from alacnet_tpu_torch.codec.encoder_device import encode_frames_device

    S = 4096
    rng = np.random.default_rng(5)
    frames = list(_music_pcm(7 * S, 16, 2, rng).reshape(7, S, 2))
    frames.append(rng.integers(-32768, 32767, (S, 2)).astype(np.int32))
    params = at.default_cookie(44100, 16, 2, S)
    cfg = at.EncoderConfig(order=6)
    timings: dict = {}
    got = encode_frames_device(frames, params, cfg, timings=timings, device=DEVICE,
                               quads=True)
    host = at.AlacEncoder(params, cfg)
    if got != [host.encode_frame(f) for f in frames]:
        raise RuntimeError("the quad route's music + noise batch differs from the host encoder")
    repacked = timings.get("repacked_frames", 0)
    if timings.get("quad_chunks") != 1 or not 0 < repacked <= len(frames) // 2:
        raise RuntimeError(f"the music + noise batch took no minority repack: {timings}")
    return {"frames": len(frames), "quad_chunks": timings["quad_chunks"],
            "repacked_frames": repacked, "d2h_bytes": timings["d2h_bytes"]}


def run_encoder_routes(decoded, names, enc_expected, card: str) -> dict:
    """Phase 10: the encoder's packing routes on the card."""
    import statistics

    import alacnet_tpu_torch

    config = alacnet_tpu_torch.EncoderConfig()
    samples = sum(decoded[n].pcm.shape[0] for n in names) * COPIES
    walls = {k: [] for k in ROUTES}
    stage_s = {k: {s: [] for s in ("prep_s", "emit_wait_s", "pack_s")} for k in ROUTES}
    launches, route_timings = {}, {}
    order = list(ROUTES.items())
    for r in range(ROUTE_RUNS + 1):  # round 0 is checked, the rest timed
        for label, route in order[r % len(order):] + order[: r % len(order)]:
            datas, wall, runs_launches, timings, chunks = route_run(
                decoded, names, config, route)
            if r == 0:
                check_route(label, route, datas, runs_launches, timings, chunks, "default",
                            names, enc_expected)
                launches[label] = {k: runs_launches.get(k, 0) for k in ENCODE_KERNELS}
                route_timings[label] = {
                    "chunks": chunks, "d2h_bytes_per_sample": timings["d2h_bytes"] / samples,
                    **{k: timings.get(k, 0) for k in (
                        "quad_chunks", "repacked_frames", "device_pack_chunks")},
                }
            else:
                walls[label].append(wall)
                for k, v in stage_s[label].items():
                    v.append(timings.get(k, 0.0))
            del datas
    for label, per in stage_s.items():  # medians over the timed rounds
        route_timings[label].update({k: statistics.median(v) for k, v in per.items()})
    rates = {}
    for label, w in walls.items():
        runs = [samples / x / 1e6 for x in w]
        rates[label] = {"msamples_per_s": samples / statistics.median(w) / 1e6,
                        "runs_msps": runs}
    for label in ROUTES:
        rates[label]["over_pair"] = (rates[label]["msamples_per_s"]
                                     / rates["pair"]["msamples_per_s"])
    # The extra-bits plane under a device-pack request: the host packer.
    ub1 = alacnet_tpu_torch.EncoderConfig(uncompressed_bytes=1)
    datas, _, ub1_launches, timings, chunks = route_run(decoded, UB1_FILES, ub1,
                                                       ROUTES["scatter"])
    check_route("scatter", ROUTES["scatter"], datas, ub1_launches, timings, chunks, "ub1",
                UB1_FILES, enc_expected)
    del datas
    rec = {"samples": samples, "runs": ROUTE_RUNS, "rates": rates, "routes": route_timings,
           "launches": launches,
           "ub1_scatter": {"chunks": chunks, "device_pack_chunks": 0,
                           "launches": {k: ub1_launches.get(k, 0) for k in ENCODE_KERNELS}},
           "repack": quad_repack_batch(card), "pack_chunk": time_pack_chunk(decoded),
           "card": card}
    emit({"encoder_routes": rec})
    return rec


#: The ``ALAC_*`` variables the port reads (``config.py``, ``native.py``,
#: ``codec/encoder_device.py``): removed before phase 1, so phases 1-10
#: run the defaults; phase 11 sets them itself, case by case.
PORT_ENV = ("ALAC_BATCH_LIMIT", "ALAC_STREAM_WINDOW", "ALAC_KERNEL", "ALAC_STRICT",
            "ALAC_EMIT16", "ALAC_NATIVE", "ALAC_DEVICE_PACK", "ALAC_ENC_KERNEL",
            "ALAC_ENC_PAIR", "ALAC_ENC_QUAD", "ALAC_ENC_DEVICE_PACK", "ALAC_ENC_PACK_IMPL",
            "ALAC_NO_NATIVE")
#: Minutes of audio in phase 11's soak (``scripts/soak_torch.py``'s
#: default: six files, 32,040,000 samples).
SOAK_MINUTES = 10.0
#: Kernels the soak's path must launch (``rice_emit`` is on no encoder path).
SOAK_KERNELS = DECODE_KERNELS + ENCODE_KERNELS
#: Where the soak calls each kernel wrapper (its decode and its device encode).
SOAK_CALL_SITES = {**CALL_SITES, **ENC_CALL_SITES}
#: Seconds of plain-version runs each kernel's soak check may spend past
#: its first call (the plain rice_lpc takes ~10 s a call at the soak's
#: 4,096-lane batches on the H100, the plain predictor ~7 s a chunk).
SOAK_PLAIN_BUDGET_S = 40.0
#: Phase 11's route variables, each set for one encode of music.m4a's PCM,
#: with the packer the route must take.
ROUTE_VARS = (
    ({"ALAC_ENC_PAIR": "0"}, "_pack_host"),
    ({"ALAC_ENC_QUAD": "1"}, "_pack_host_pairs"),
    ({"ALAC_ENC_DEVICE_PACK": "1", "ALAC_ENC_PACK_IMPL": "scatter"}, "_pack_device"),
    ({"ALAC_ENC_DEVICE_PACK": "1", "ALAC_ENC_PACK_IMPL": "gather"}, "_pack_device"),
)


def clear_port_env() -> list:
    """Remove every variable of ``PORT_ENV`` from the environment; the
    ones removed, with their values."""
    import os

    return [(k, os.environ.pop(k)) for k in PORT_ENV if k in os.environ]


@contextlib.contextmanager
def env_set(values: dict):
    """The variables ``values`` set for the block, removed after it."""
    import os

    os.environ.update(values)
    try:
        yield
    finally:
        for k in values:
            os.environ.pop(k, None)


def _scripts():
    sys.path.insert(0, str(ROOT / "scripts"))
    import soak_torch

    return soak_torch


def record_soak_calls(calls):
    """``wrapped`` factories that append each kernel wrapper call of the
    soak to ``calls[kernel]`` as (args, kwargs, group): a decode call's
    group is its place among its batch's calls of that kernel, the
    batch's formats and its ``max_order``; an encode call's is the
    ``encode_frames_device`` run (one a file) it belongs to."""
    state = {"placed": {}, "formats": None, "run": -1}

    def make(key, orig):
        def rec(*args, **kwargs):
            if key in ENCODE_KERNELS:
                group = state["run"]
            else:
                place = state["placed"].get(key, 0)
                state["placed"][key] = place + 1
                group = (place, state["formats"], kwargs.get("max_order"))
            calls.setdefault(key, []).append((args, kwargs, group))
            return orig(*args, **kwargs)
        return rec

    def per_batch(key, orig):
        def run(fb, *args, **kwargs):
            state.update(formats=batch_formats(fb), placed={})
            return orig(fb, *args, **kwargs)
        return run

    def per_run(key, orig):
        def run(*args, **kwargs):
            state["run"] += 1
            return orig(*args, **kwargs)
        return run

    return make, per_batch, per_run


def compare_soak_calls(calls, budget_s) -> dict:
    """Phase 11 (a)'s kernel checks: the calls the soak made
    (``record_soak_calls``) run again through the kernel and through the
    plain version, bit for bit — the first call of each group (one of
    each decode batch's formats before a second), then the other calls,
    while the kernel's plain total stays under ``budget_s`` (its first
    call always).  Fails unless every kernel of ``SOAK_KERNELS`` was
    compared at least once."""
    import torch

    fns = {**decode_fns(), **enc_fns()}
    torch.cuda.synchronize()
    results = {}
    for name in SOAK_KERNELS:
        recorded = calls.get(name, [])
        if not recorded:
            raise RuntimeError(f"soak: no {name} call recorded")
        fn = fns[name]
        # The first call of each group, those of formats not yet taken
        # first (a decode group's formats are its second field), then the rest.
        firsts, seen, taken = [], set(), {}
        for idx, (_, _, group) in enumerate(recorded):
            if group not in seen:
                seen.add(group)
                family = group[1] if isinstance(group, tuple) else group
                firsts.append((taken.get(family, 0), idx))
                taken[family] = taken.get(family, 0) + 1
        firsts = [idx for _, idx in sorted(firsts)]
        order = firsts + [i for i in range(len(recorded)) if i not in set(firsts)]
        err, ms, plain_ms, compared, shapes, groups = 0, 0.0, 0.0, [], [], set()
        for idx in order:
            if compared and plain_ms / 1e3 >= budget_s:
                break
            args, kw, group = recorded[idx]
            got = []
            ms += cuda_ms(lambda: got.append(fn(*args, **{**kw, "kernel": "cuda"})), 1)
            plain = []
            plain_ms += cuda_ms(
                lambda: plain.append(fn(*args, **{**kw, "kernel": "torch"})), 1
            )
            err = max(err, max_abs_err(name, got[0], plain[0]))
            if err != 0:  # the tolerance: bit for bit
                raise RuntimeError(f"soak {name} call {idx}: kernel differs from plain, "
                                   f"max |err| {err}")
            compared.append(idx)
            groups.add(group)
            shapes.append(list((got[0] if isinstance(got[0], tuple) else (got[0],))[0].shape))
        results[name] = {"calls": len(recorded), "groups": len(seen),
                         "compared_calls": sorted(compared), "compared_groups": len(groups),
                         "shapes": shapes, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms}
        if name == "rice_lpc":
            results[name]["max_orders"] = sorted(
                {recorded[i][1].get("max_order") for i in compared}, key=str)
        emit({"soak_kernel_check": name, **results[name]})
    return results


def run_soak_phase(card: str) -> dict:
    """Phase 11 (a): ``scripts/soak_torch.run_soak`` on the card, the
    launch counts set to 0 just before and read just after, each kernel
    wrapper call recorded; then the recorded calls through kernel and
    plain version (``compare_soak_calls``)."""
    import torch

    from alacnet_tpu_torch.ops.cuda import _lib

    soak = _scripts()
    calls = {}
    make, per_batch, per_run = record_soak_calls(calls)
    with tempfile.TemporaryDirectory() as tmp, wrapped(SOAK_CALL_SITES, make), \
            wrapped(DISPATCH_SITE, per_batch), wrapped(ENCODE_DEVICE, per_run):
        torch.cuda.synchronize()
        _lib.reset_launches()
        rec = soak.run_soak(SOAK_MINUTES, tmp, DEVICE, log=lambda *a: None)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
    if not rec["encode_host_device_bytes_equal"]:
        raise RuntimeError(f"soak: device bytes differ from the host encoder's: {rec['files']}")
    if not rec["decode_bit_exact"]:
        raise RuntimeError(f"soak: a decoded file differs from its source: {rec['files']}")
    idle = [k for k in SOAK_KERNELS if launches.get(k, 0) == 0]
    if idle:
        raise RuntimeError(f"soak: {idle} never launched: {launches}")
    rec.update(launches=launches, card=card)
    emit({"soak": rec})
    t = time.perf_counter()
    rec["kernel_checks"] = compare_soak_calls(calls, SOAK_PLAIN_BUDGET_S)
    rec["kernel_checks_s"] = time.perf_counter() - t
    del calls
    torch.cuda.empty_cache()
    return rec


def run_fuzz_phase(card: str) -> list:
    """Phase 11 (b): the fuzz batches through ``decode_frames`` with
    ``kernel="cuda"`` and ``kernel="torch"``, lane by lane
    (``soak_torch.fuzz_routes``: clipped lanes counted, the rest equal)."""
    recs = _scripts().fuzz_routes(DEVICE, ("cuda", "torch"))
    emit({"fuzz": recs, "card": card})
    bad = [r for r in recs if not r["equal"]]
    if bad:
        raise RuntimeError(f"fuzz: kernel and plain differ on unclipped lanes: {bad}")
    return recs


def route_variables(decoded, enc_expected, card: str) -> list:
    """Phase 11 (c): music.m4a's PCM encoded once (``encode_files(
    device="cuda")``, one chunk of 16 frames) under each of
    ``ROUTE_VARS``: the bytes against ``encode_expected.json`` and the
    packer that ran against the variable's."""
    import alacnet_tpu_torch
    from alacnet_tpu_torch.codec import encoder_device as ed

    name = "music.m4a"
    want = enc_expected[f"{name}|default"]
    r = decoded[name]
    ran = []

    def spy(key, orig):
        def run(*args, **kwargs):
            ran.append(key)
            return orig(*args, **kwargs)
        return run

    packers = {k: ("alacnet_tpu_torch.codec.encoder_device", k)
               for k in ("_pack_host", "_pack_host_pairs", "_pack_device")}
    recs = []
    for values, packer in ROUTE_VARS:
        ran.clear()
        out = io.BytesIO()
        with env_set(values), wrapped(packers, spy):
            route = ed.resolve_routes()
            alacnet_tpu_torch.encode_files([r.pcm], [out], r.sample_rate, r.bits_per_sample,
                                           device=DEVICE)
        data = out.getvalue()
        ok = (len(data) == want["bytes"]
              and hashlib.sha256(data).hexdigest() == want["sha256"])
        rec = {"env": values, "route": route, "packers": list(ran), "bytes_equal": ok}
        recs.append(rec)
        if not ok:
            raise RuntimeError(f"route variables {values}: bytes differ from "
                               "encode_expected.json")
        if ran != [packer]:
            raise RuntimeError(f"route variables {values}: packed by {ran}, "
                               f"expected {packer}")
    emit({"route_variables": recs, "card": card})
    return recs


def run_phase11(decoded, enc_expected, card: str) -> dict:
    """Phase 11: the soak and its kernel checks, the fuzz, the route
    variables."""
    times = {}
    t = time.perf_counter()
    soak = run_soak_phase(card)
    times["soak_s"] = time.perf_counter() - t
    t = time.perf_counter()
    fuzz = run_fuzz_phase(card)
    times["fuzz_s"] = time.perf_counter() - t
    t = time.perf_counter()
    routes = route_variables(decoded, enc_expected, card)
    times["routes_s"] = time.perf_counter() - t
    times["soak_checks_s"] = soak["kernel_checks_s"]
    return {"soak": soak, "fuzz": fuzz, "routes": routes,
            "times": times}


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
          "cuda": torch.version.cuda, "removed_env": clear_port_env()})

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

    torch.cuda.empty_cache()
    t = time.perf_counter()
    bench = run_bench()
    emit({"phase": 8, "seconds": time.perf_counter() - t,
          "trace_bytes": bench["trace_bytes"]})

    t = time.perf_counter()
    mesh = run_mesh_phase(names, data, decoded, expected, enc_expected, smi)
    emit({"phase": 9, "seconds": time.perf_counter() - t})

    t = time.perf_counter()
    routes = run_encoder_routes(decoded, names, enc_expected, smi)
    emit({"phase": 10, "seconds": time.perf_counter() - t})

    torch.cuda.empty_cache()
    t = time.perf_counter()
    p11 = run_phase11(decoded, enc_expected, smi)
    del decoded
    emit({"phase": 11, "seconds": time.perf_counter() - t, **p11["times"]})
    mesh_launches = {**mesh["decode"]["two_shards"]["launches"], **mesh["encode"]["launches"]}
    shard_checks = mesh["shard_checks"]
    soak_checks = p11["soak"]["kernel_checks"]

    launches = {**e2e["launches"], **enc["launches"], **route["launches"]}
    kernels = [
        {"name": k, "route": "cuda", "source": f"alacnet_tpu_torch/csrc/{k}.cu",
         "replaces": KERNELS[k], "path": KERNEL_PATHS[k], "launches": launches[k],
         "bench_launches": bench["launches"].get(k, 0),
         "mesh_launches": mesh_launches.get(k, 0),
         "soak_launches": p11["soak"]["launches"].get(k, 0),
         "route_launches": ({r: n[k] for r, n in routes["launches"].items()}
                            if k in ENCODE_KERNELS else None),
         "mesh_max_abs_err": shard_checks[k]["max_abs_err"] if k in shard_checks else None,
         "mesh_plain_calls": (shard_checks[k]["compared_by_stream"]
                              if k in shard_checks else None),
         "soak_max_abs_err": soak_checks[k]["max_abs_err"] if k in soak_checks else None,
         "soak_plain_calls": (len(soak_checks[k]["compared_calls"])
                              if k in soak_checks else None),
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
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:8]))
    sys.exit(main())
