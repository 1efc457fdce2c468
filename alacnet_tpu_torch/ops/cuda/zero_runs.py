"""The encoder's zero-run lookahead on the kernels' sample-major plane.

The counterpart of the reverse ``lax.cummin`` that the JAX package's
``ops/pallas/enc_stages.encode_stages_pcm`` runs between its two Pallas
kernels (XLA, kept out of Pallas there).  Kernel 8 of the encode path
(``csrc/zero_runs.cu``): one launch, a block a strip of lanes walking
the whole (S, B) residual plane backward, 16-byte loads and stores of 4
neighbouring lanes a thread, the next break carried from pass to pass
and scanned across the pass's row groups in shared memory; no scratch
in device memory.  The plain version is ``ops/encode.zero_run_lengths_sb``.
"""

from __future__ import annotations

import functools

import torch

from ..encode import zero_run_lengths_sb
from . import _lib

#: Lanes a block may own (``strip`` of the C entry), widest first.
STRIPS = (16, 8)
#: The narrower strip is taken where the wider one leaves more than
#: this share of the SMs without a block.
IDLE_SHARE = 0.5


def _sms(dev: torch.device) -> int:
    """The SM count of CUDA device ``dev``."""
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pick_strip(B: int, sms: int) -> int:
    """Lanes a block for B lanes on a card of ``sms`` SMs."""
    wide, narrow = STRIPS
    return wide if -(-B // wide) >= (1 - IDLE_SHARE) * sms else narrow


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
    if B * max(S, 1) >= 1 << 31:
        raise ValueError(f"zero_run_lengths_fused: bad shape S={S} B={B}")
    dev = errs_sb.device
    _lib.check_i32("errs_sb", errs_sb, (S, B), dev)
    _lib.check_i32("n", n, (B,), dev)
    out = torch.empty((S, B), dtype=torch.int32, device=dev)
    if B and S:
        _lib.launch("alac_zero_runs", dev, errs_sb.data_ptr(), n.data_ptr(), B, S,
                    pick_strip(B, _sms(dev)), out.data_ptr())
    return out
