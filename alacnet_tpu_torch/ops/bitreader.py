"""Batched bit-field reads over packed frame words, in torch.

The counterpart of ``alacnet_tpu/ops/bitreader.py``.  Frame payloads
are packed into big-endian 32-bit words, carried on the torch side as
``int32`` bit patterns, and zero-padded with >= WINDOW_PAD words of
slack so clamped reads never leave the row.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitops import lsr

#: Words read per Rice event window (ops/rice.py).
WINDOW_WORDS = 4
#: Zero words of slack appended past the longest frame.
WINDOW_PAD = WINDOW_WORDS + 1


def pack_frames_to_words(frames: list[bytes], max_bytes: int | None = None) -> np.ndarray:
    """Pack variable-length frame payloads into a (B, W) uint32 matrix.

    Each row is one frame's bytes, big-endian packed, zero padded. ``W``
    includes WINDOW_PAD words of slack, rounded to a multiple of 8.
    """
    if max_bytes is None:
        max_bytes = max((len(f) for f in frames), default=0)
    nwords = -(-(-(-max_bytes // 4) + WINDOW_PAD) // 8) * 8
    B = len(frames)
    out = np.zeros((B, nwords * 4), dtype=np.uint8)
    if B:
        lens = np.fromiter((len(f) for f in frames), np.int64, B)
        src = np.frombuffer(b"".join(frames), np.uint8)
        mask = np.arange(nwords * 4, dtype=np.int64)[None, :] < lens[:, None]
        out[mask] = src
    return out.view(">u4").astype(np.uint32)


def gather_bits(words: torch.Tensor, bitpos: torch.Tensor, nbits) -> torch.Tensor:
    """Arbitrary-position field read: one 2-word gather per element.

    words: (B, W) int32; bitpos: (B, S) int32 grid; nbits broadcastable
    to it, 0..25.  Returns the right-aligned fields as int32.
    """
    w = torch.clamp(bitpos >> 5, 0, words.shape[1] - 2).to(torch.int64)
    hi = torch.gather(words, 1, w)
    lo = torch.gather(words, 1, w + 1)
    s2 = bitpos & 31
    straddle = torch.where(s2 == 0, 0, lsr(lo, (32 - s2) & 31))
    x = (hi << s2) | straddle
    return lsr(x, (32 - nbits) & 31)
