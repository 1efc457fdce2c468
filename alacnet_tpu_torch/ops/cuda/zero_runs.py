"""The encoder's zero-run lookahead on the kernels' sample-major plane.

The counterpart of the reverse ``lax.cummin`` that the JAX package's
``ops/pallas/enc_stages.encode_stages_pcm`` runs between its two Pallas
kernels (XLA, kept out of Pallas there).  Kernel 8 of the encode path
(``csrc/zero_runs.cu``): the (S, B) residual plane cut into 64-sample
tiles on the grid, a thread a (tile, lane); one launch finds each
tile's first break, a second walks each tile backward from the first
break after it.  The plain version is ``ops/encode.zero_run_lengths_sb``.
"""

from __future__ import annotations

import torch

from ..encode import zero_run_lengths_sb
from . import _lib

#: Samples of a tile (``kTile``): the kernel's scratch is (ceil(S/TILE), B).
TILE = 64


def zero_run_lengths_fused(
    errs_sb: torch.Tensor,  # (S, B) int32 residuals, sample-major
    n: torch.Tensor,  # (B,) int32 valid counts (not clamped)
    kernel: str = "auto",
) -> torch.Tensor:
    """(S, B) int32: at i, the zero residuals from i + 1 up to the next
    nonzero residual or the lane's n, capped at 0xFFFF; 0 at S - 1."""
    if not _lib.use_kernel(errs_sb, kernel):
        return zero_run_lengths_sb(errs_sb, n)
    S, B = errs_sb.shape
    tiles = -(-S // TILE)
    if B * max(S, 1) >= 1 << 31 or tiles > _lib.MAX_GRID_Y:
        raise ValueError(f"zero_run_lengths_fused: bad shape S={S} B={B}")
    dev = errs_sb.device
    _lib.check_i32("errs_sb", errs_sb, (S, B), dev)
    _lib.check_i32("n", n, (B,), dev)
    out = torch.empty((S, B), dtype=torch.int32, device=dev)
    if B and S:
        first = torch.empty((tiles, B), dtype=torch.int32, device=dev)
        _lib.launch("alac_zero_runs", dev, errs_sb.data_ptr(), n.data_ptr(), B, S,
                    first.data_ptr(), out.data_ptr())
    return out
