"""The yardstick: the card's peaks and the work a kernel must do.

Frozen here so that no later change to the port moves it.  The work of
each kernel is counted from the benchmark's own inputs (each frame's
live samples, channels, predictor orders and the bits of its Rice
sections, as the frozen encoder wrote them), never from a kernel's
arguments, so it stays the same whatever implements the work.  Each
input byte is counted read once and each output byte written once.

Origin: ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``INT32_OPS_PER_S``,
``INT_OPS`` and ``call_work``, whose byte and operation arithmetic is
copied below per kernel.
"""

from __future__ import annotations

import numpy as np

#: H100 SXM memory rate, bytes/s (NVIDIA's H100 data sheet, 700 W part).
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM int32 issue rate, ops/s.  Not published: derived as 132 SMs x
#: 64 INT32 lanes per SM (Hopper white paper: 4 sub-partitions x 16) x
#: the 1.98 GHz boost clock (data sheet) = 16.73e12.  A card whose
#: power limit (``nvidia-smi``'s ``power.limit``, reported beside every
#: run) is below 700 W clocks lower under load.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: Estimated int32 operations per item, counted from the plain versions'
#: expressions (``chip_smoke.INT_OPS``): per live sample, per FIR tap of a
#: live sample.
INT_OPS = {
    "rice_lpc": {"sample": 40, "tap": 4},
    "bulk_bits": {"sample": 16},
    "enc_pred": {"sample": 20, "tap": 4},
    "enc_rice": {"sample": 135},
}


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card can take: bytes at the memory rate or
    operations at the int32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def _taps(order: np.ndarray, n: np.ndarray) -> int:
    return int((np.where(order >= 31, 0, np.clip(order, 0, None)) * n).sum())


def rice_lpc_work(f) -> tuple[int, int]:
    """Decode's Rice + LPC pass, a lane per channel of each frame: its
    Rice section's words, 9 lane parameters and the end written (40 B),
    32 coefficients (128 B) and the live samples out."""
    n = np.repeat(f.n, f.channels)
    order = f.orders[:, : f.channels].reshape(-1)
    bits = f.rice_bits[:, : f.channels].reshape(-1)
    words = int(((bits + 31) // 32).sum())
    live = int(n.sum())
    lanes = n.size
    nbytes = 4 * words + 40 * lanes + 128 * lanes + 4 * live
    ops = INT_OPS["rice_lpc"]
    return nbytes, ops["sample"] * live + ops["tap"] * _taps(order, n)


def bulk_bits_work(f) -> tuple[int, int]:
    """The extra-bits fields of each frame (8 bits a byte of
    ``uncompressed_bytes``, a field per channel and sample), 16 B of lane
    parameters, and two int32 planes of live samples out."""
    if not f.uncompressed_bytes:
        return 0, 0
    n = f.n
    field_bits = int((n * f.channels * 8 * f.uncompressed_bytes).sum())
    live = int(n.sum())
    nbytes = field_bits // 8 + 16 * n.size + 8 * live
    return nbytes, INT_OPS["bulk_bits"]["sample"] * live


def enc_pred_work(f) -> tuple[int, int]:
    """The encoder's predictor, a lane per channel: samples in and
    residuals out (8 B a live sample), 16 B of lane parameters and 32
    coefficients."""
    n = np.repeat(f.n, f.channels)
    order = f.orders[:, : f.channels].reshape(-1)
    live = int(n.sum())
    nbytes = 8 * live + 16 * n.size + 128 * n.size
    ops = INT_OPS["enc_pred"]
    return nbytes, ops["sample"] * live + ops["tap"] * _taps(order, n)


def enc_rice_work(f) -> tuple[int, int]:
    """The encoder's Rice state machine with the merge, a lane per
    channel: residuals and zero runs in, the merged planes out (21 B a
    live sample), 29 B a lane."""
    n = np.repeat(f.n, f.channels)
    live = int(n.sum())
    return 21 * live + 29 * n.size, INT_OPS["enc_rice"]["sample"] * live


def roofline_pct(window, work, *name_parts: str) -> float | None:
    """A kernel's share of its roofline over the traced window, in %: the
    least time of ``work(window.frames)`` over the summed time of the
    device kernels whose names hold every one of ``name_parts``.  None
    when the trace holds no such kernel or there was no work."""
    if window.trace is None or window.frames is None:
        return None
    seconds = window.trace.kernel_seconds(*name_parts)
    if not seconds:
        return None
    nbytes, ops = work(window.frames)
    if not (nbytes or ops):
        return None
    return 100.0 * least_seconds(nbytes, ops) / seconds
