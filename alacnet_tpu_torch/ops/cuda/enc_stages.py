"""The encoder's two per-sample automatons as CUDA kernels.

The counterpart of ``alacnet_tpu/ops/pallas/enc_stages.py``:

* :func:`predictor_errors_fused` — ``csrc/enc_pred.cu`` (replaces
  ``_pred_kernel``): signal -> residuals, the forward adaptive FIR and
  its coefficient walk.  Plain version: ``ops/encode.predictor_errors``.
* :func:`rice_merge_fused` — ``csrc/enc_rice.cu`` (replaces
  ``_rice_kernel``): residuals + zero-run lookahead -> merged 96-bit
  chunk planes, widths, per-lane bit totals and the desync flag.  Plain
  version: ``ops/encode.rice_symbols`` -> ``merge_symbol_chunks`` ->
  ``bits = ws.sum(1)``.
* :func:`encode_stages_fused` — runs the stages: predictor kernel,
  the zero-run lookahead (``csrc/zero_runs.cu``, ``ops/cuda/zero_runs.py``),
  Rice kernel.

Both kernels give a block 16 lanes and split each lane's
work across warps that hand tiles of samples over through shared
memory: in ``enc_pred`` a producer warp stages the signal and stores
the residuals while a predictor warp runs the chain, compiled per order
bucket (``rice_lpc.ORDER_BUCKETS``); in ``enc_rice`` a state warp runs
the automaton's serial part and emit warps the symbols and the merge
(see the sources).  They read and write sample-major (S, B) planes.
The wrappers take and return (B, S) tensors: a (B, S) input is
transposed to (S, B) storage (a no-op when it already is the transposed
view of such storage, as the predictor's output is), and outputs are the
(B, S) views of the kernels' (S, B) buffers.  They take any B and S: no
lane or sample padding.
"""

from __future__ import annotations

import torch

from ..encode import (
    RiceEncParams,
    merge_symbol_chunks,
    predictor_errors,
    rice_symbols,
)
from ..lpc import MAX_ORDER, LpcParams
from . import _lib
from .rice_lpc import order_bucket
from .zero_runs import zero_run_lengths_fused


def _sample_major(name: str, x: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """(B, S) int32 tensor -> contiguous (S, B) storage."""
    if tuple(x.shape) != (B, S):
        raise ValueError(f"{name}: expected shape {(B, S)}, got {tuple(x.shape)}")
    xt = x.t().contiguous()
    _lib.check_i32(name, xt, (S, B), xt.device)
    return xt


def predictor_errors_fused(
    sig: torch.Tensor,  # (B, S) int32 channel values
    n: torch.Tensor,  # (B,) int32 valid counts
    lp: LpcParams,
    num_samples: int,
    max_order: int = MAX_ORDER,
    kernel: str = "auto",
) -> torch.Tensor:
    """Residuals whose decode reproduces ``sig``: (B, S) int32.

    ``max_order`` bounds the FIR and the adaptive walk, as the JAX
    kernel's static bound does (pass at least every lane's order below
    31), and picks the CUDA kernel's order bucket.
    """
    if not _lib.use_kernel(sig, kernel):
        return predictor_errors(sig, n, lp, num_samples, max_order=max_order)
    B = sig.shape[0]
    S = num_samples
    if not 0 <= max_order <= MAX_ORDER or B * max(S, 1) >= 1 << 31:
        raise ValueError(f"predictor_errors_fused: bad shape B={B} S={S} "
                         f"max_order={max_order}")
    dev = sig.device
    sig_sb = _sample_major("sig", sig, B, S)
    params = (n, lp.rss, lp.order, lp.quant)
    for i, t in enumerate(params):
        _lib.check_i32(f"param {i}", t, (B,), dev)
    _lib.check_i32("rc", lp.rc, (B, MAX_ORDER + 1), dev)
    errs_sb = torch.empty((S, B), dtype=torch.int32, device=dev)
    if B and S:
        _lib.launch(
            "alac_enc_pred", dev, sig_sb.data_ptr(), B, S,
            *(t.data_ptr() for t in params), lp.rc.data_ptr(), max_order,
            order_bucket(max_order), errs_sb.data_ptr(),
        )
    return errs_sb.t()


def rice_merge_plain(errs, zruns, n, rp: RiceEncParams, num_samples: int):
    """Plain torch version of :func:`rice_merge_fused`."""
    v16, v32, widths, bad = rice_symbols(errs, zruns, n, rp, num_samples)
    c0, c1, c2, ws = merge_symbol_chunks(v16, v32, widths)
    bits = ws.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return c0, c1, c2, ws, bits, bad


def rice_merge_fused(
    errs: torch.Tensor,  # (B, S) int32 residuals
    zruns: torch.Tensor,  # (B, S) int32 zero-run lookahead
    n: torch.Tensor,  # (B,) int32 valid counts
    rp: RiceEncParams,
    num_samples: int,
    kernel: str = "auto",
):
    """The Rice emitter with the 4-field chunk merge fused in.

    Returns (c0, c1, c2 (B, S) int32 bit patterns of the right-aligned
    96-bit chunks, ws (B, S) int8 widths, bits (B,) int32, bad (B,)
    bool).
    """
    if not _lib.use_kernel(errs, kernel):
        return rice_merge_plain(errs, zruns, n, rp, num_samples)
    B = errs.shape[0]
    S = num_samples
    if B * max(S, 1) >= 1 << 31:
        raise ValueError(f"rice_merge_fused: bad shape B={B} S={S}")
    dev = errs.device
    errs_sb = _sample_major("errs", errs, B, S)
    zr_sb = _sample_major("zruns", zruns, B, S)
    params = (n, rp.rss, rp.kmod, rp.init_history, rp.mult, rp.kmask)
    for i, t in enumerate(params):
        _lib.check_i32(f"param {i}", t, (B,), dev)
    c0, c1, c2 = (torch.empty((S, B), dtype=torch.int32, device=dev) for _ in range(3))
    ws = torch.empty((S, B), dtype=torch.int8, device=dev)
    bits = torch.empty((B,), dtype=torch.int32, device=dev)
    bad = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        _lib.launch(
            "alac_enc_rice", dev, errs_sb.data_ptr(), zr_sb.data_ptr(), B, S,
            *(t.data_ptr() for t in params),
            c0.data_ptr(), c1.data_ptr(), c2.data_ptr(), ws.data_ptr(),
            bits.data_ptr(), bad.data_ptr(),
        )
    return c0.t(), c1.t(), c2.t(), ws.t(), bits, bad


def encode_stages_fused(
    sig, n, lp: LpcParams, rp: RiceEncParams, num_samples: int,
    max_order: int = MAX_ORDER, kernel: str = "auto",
):
    """Residuals -> zero-run lookahead -> merged chunk planes.

    Returns (c0, c1, c2 (B, S) int32, ws (B, S) int8, bits (B,) int32,
    bad (B,) bool).  The residual plane stays in the kernels' (S, B)
    layout between the launches, and the zero-run lookahead runs along
    its sample axis.
    """
    errs = predictor_errors_fused(
        sig, n, lp, num_samples, max_order=max_order, kernel=kernel
    )
    zr = zero_run_lengths_fused(errs.t(), n, kernel=kernel).t()
    return rice_merge_fused(errs, zr, n, rp, num_samples, kernel=kernel)
