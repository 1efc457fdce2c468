"""The encoder's Rice emitter with unmerged symbol planes, as a CUDA kernel.

The counterpart of ``alacnet_tpu/ops/pallas/rice_emit.py``:
:func:`rice_symbols_fused` is ``csrc/rice_emit.cu`` (replaces
``_kernel``, reached via ``rice_symbols_fused``).  Its plain version is
``ops/encode.rice_symbols``.  The planes feed the native symbol packer
(``native.pack_symbol_frames_native``); like the JAX package, no encoder
path runs this route: the production encoder merges the fields on the
card (``enc_rice``).

The kernel reads sample-major (S, B) planes and writes (S, B, k) ones;
the wrapper takes (B, S) inputs and returns the (B, S, k) views.  Any B
and S: no lane or sample padding.  The values are the plain version's
everywhere, also where their width is 0.
"""

from __future__ import annotations

import torch

from ..encode import RiceEncParams, rice_symbols
from . import _lib
from .enc_stages import _sample_major


def rice_symbols_fused(
    errs: torch.Tensor,  # (B, S) int32 residuals
    zruns: torch.Tensor,  # (B, S) int32 zero-run lookahead
    n: torch.Tensor,  # (B,) int32 valid counts
    rp: RiceEncParams,
    num_samples: int,
    kernel: str = "auto",
):
    """The Rice emitter automaton -> fixed-arity bit-field planes.

    Returns (vals16 (B, S, 2) int16 — the unary/marker fields [v0, v2],
    vals32 (B, S, 2) int32 — the remainder/escape fields [v1, v3],
    widths (B, S, 4) int8 in field order v0, v1, v2, v3, bad (B,) bool),
    as :func:`~alacnet_tpu_torch.ops.encode.rice_symbols` does.
    """
    if not _lib.use_kernel(errs, kernel):
        return rice_symbols(errs, zruns, n, rp, num_samples)
    B = errs.shape[0]
    S = num_samples
    if B * max(S, 1) >= 1 << 31:
        raise ValueError(f"rice_symbols_fused: bad shape B={B} S={S}")
    dev = errs.device
    errs_sb = _sample_major("errs", errs, B, S)
    zr_sb = _sample_major("zruns", zruns, B, S)
    params = (n, rp.rss, rp.kmod, rp.init_history, rp.mult, rp.kmask)
    for i, t in enumerate(params):
        _lib.check_i32(f"param {i}", t, (B,), dev)
    v16 = torch.empty((S, B, 2), dtype=torch.int16, device=dev)
    v32 = torch.empty((S, B, 2), dtype=torch.int32, device=dev)
    widths = torch.empty((S, B, 4), dtype=torch.int8, device=dev)
    bad = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        _lib.launch(
            "alac_rice_emit", dev, errs_sb.data_ptr(), zr_sb.data_ptr(), B, S,
            *(t.data_ptr() for t in params),
            v16.data_ptr(), v32.data_ptr(), widths.data_ptr(), bad.data_ptr(),
        )
    return v16.transpose(0, 1), v32.transpose(0, 1), widths.transpose(0, 1), bad
