"""Fixed-stride bulk bit extraction.

The counterpart of ``alacnet_tpu/ops/pallas/bulk_bits.py``.  Kernel 3
of the decode path (``csrc/bulk_bits.cu``): for each lane, two
right-aligned fields of widths n1 and n2 at a fixed stride n1 + n2
(<= 48 bits) per sample.  It serves the extra-bits side channel
(``ub*8``-bit fields) and the bodies of uncompressed frames
(``sample_size``-bit fields); sign extension stays in the epilogue
(``ops/frame_decode.py``).  The plain version reads the same fields with
``bitreader.gather_bits``.
"""

from __future__ import annotations

import torch

from ..bitreader import gather_bits
from . import _lib

#: Samples of one lane that a block of the kernel extracts (``kSamples``).
SAMPLES_PER_BLOCK = 1024


def bulk_bits_plain(words, start, n, n1, n2, num_samples: int):
    """Plain torch version: one two-word gather per field."""
    i = torch.arange(num_samples, dtype=torch.int32, device=words.device)
    n1c, n2c = n1[:, None], n2[:, None]
    pos = start[:, None] + i[None, :] * (n1c + n2c)
    live = i[None, :] < n[:, None]
    a = torch.where(live, gather_bits(words, pos, n1c), 0)
    b = torch.where(live & (n2c > 0), gather_bits(words, pos + n1c, n2c), 0)
    return a, b


def bulk_bits(
    words: torch.Tensor,  # (B, W) int32 word rows
    start: torch.Tensor,  # (B,) int32 first field's bit position
    n: torch.Tensor,  # (B,) int32 samples per lane (0 freezes)
    n1: torch.Tensor,  # (B,) int32 first-field width, 1..32 where active
    n2: torch.Tensor,  # (B,) int32 second-field width, 0..24 (0: one field)
    num_samples: int,
    kernel: str = "auto",
):
    """Extract (A, B) field streams at a fixed per-lane stride.

    Returns (a (B, S) int32, b (B, S) int32, stalled (B,) bool); the
    CUDA kernel never stalls, so ``stalled`` is all False (kept for the
    JAX interface).  On the card the kernel writes all three (the planes
    are the two halves of one allocation): one launch a call.
    """
    B, W = words.shape
    if not _lib.use_kernel(words, kernel):
        stalled = torch.zeros((B,), dtype=torch.bool, device=words.device)
        return (*bulk_bits_plain(words, start, n, n1, n2, num_samples), stalled)
    S = num_samples
    if W <= 0 or B * max(S, 1) >= 1 << 31 or S > _lib.MAX_GRID_Y * SAMPLES_PER_BLOCK:
        raise ValueError(f"bulk_bits: bad shape B={B} W={W} S={S}")
    dev = words.device
    _lib.check_i32("words", words, (B, W), dev)
    for name, t in (("start", start), ("n", n), ("n1", n1), ("n2", n2)):
        _lib.check_i32(name, t, (B,), dev)
    a, b = torch.empty((2, B, S), dtype=torch.int32, device=dev).unbind(0)
    stalled = torch.empty((B,), dtype=torch.bool, device=dev)
    _lib.launch(
        "alac_bulk_bits", dev, words.data_ptr(), B, W, start.data_ptr(),
        n.data_ptr(), n1.data_ptr(), n2.data_ptr(), S, a.data_ptr(),
        b.data_ptr(), stalled.data_ptr(),
    )
    return a, b, stalled
