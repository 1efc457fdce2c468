"""Fused Rice + adaptive-LPC decode of one channel per lane.

The counterpart of ``alacnet_tpu/ops/pallas/rice_lpc.py``'s
``fused_rice_lpc`` without its TPU-only arguments (tile plans, fetch
policies, streaming window).  Kernel 2 of the decode path
(``csrc/rice_lpc.cu``): one thread per lane runs the sample loop; it
takes any B and any W, and never stalls.  The plain version is
``rice.rice_decode`` followed by ``lpc.lpc_decode``.
"""

from __future__ import annotations

import torch

from ..lpc import MAX_ORDER, LpcParams, lpc_decode
from ..rice import RiceParams, rice_decode
from . import _lib


def fused_rice_lpc_plain(
    words, start, n, rss, kmod, init_history, mult, kmask, order, quant, rc,
    num_samples: int,
):
    """Plain torch version: the entropy scan, then the FIR scan."""
    err, end = rice_decode(
        words, start, n, RiceParams(rss, kmod, init_history, mult, kmask),
        num_samples,
    )
    out = lpc_decode(err, n, LpcParams(order, quant, rc, rss), num_samples)
    return out, end


def fused_rice_lpc(
    words: torch.Tensor,  # (B, W) int32 word rows
    start: torch.Tensor,  # (B,) int32 start bit
    n: torch.Tensor,  # (B,) int32 samples to decode (0 freezes a lane)
    rss, kmod, init_history, mult, kmask,  # (B,) int32 Rice params
    order, quant,  # (B,) int32 LPC params
    rc: torch.Tensor,  # (B, 32) int32 base-aligned reversed coefs
    num_samples: int,
    max_order: int = MAX_ORDER,
    kernel: str = "auto",
):
    """Decode + reconstruct one channel for a lane batch.

    Returns (out (B, num_samples) int32, end bit position (B,) int32).
    ``max_order`` bounds the FIR and the adaptive walk, as the JAX
    kernel's static bound does (pass at least every lane's order below
    31).  The kernel's output is the transposed view of sample-major
    (S, B) scratch; the plain version's is contiguous.
    """
    if not _lib.use_kernel(words, kernel):
        return fused_rice_lpc_plain(
            words, start, n, rss, kmod, init_history, mult, kmask, order,
            quant, rc, num_samples,
        )
    B, W = words.shape
    S = num_samples
    if W <= 0 or not 0 <= max_order <= MAX_ORDER or B * max(S, 1) >= 1 << 31:
        raise ValueError(f"fused_rice_lpc: bad shape B={B} W={W} S={S} "
                         f"max_order={max_order}")
    dev = words.device
    _lib.check_i32("words", words, (B, W), dev)
    params = (start, n, rss, kmod, init_history, mult, kmask, order, quant)
    for i, t in enumerate(params):
        _lib.check_i32(f"param {i}", t, (B,), dev)
    _lib.check_i32("rc", rc, (B, MAX_ORDER + 1), dev)
    out_sb = torch.empty((S, B), dtype=torch.int32, device=dev)
    end = torch.empty((B,), dtype=torch.int32, device=dev)
    _lib.launch(
        "alac_rice_lpc", words.data_ptr(), B, W,
        *(t.data_ptr() for t in params), rc.data_ptr(),
        S, max_order, out_sb.data_ptr(), end.data_ptr(),
    )
    return out_sb.t(), end
