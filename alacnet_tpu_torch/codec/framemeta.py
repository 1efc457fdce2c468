"""Host-side per-lane frame parameters: the :class:`FrameBatch`.

The counterpart of ``alacnet_tpu/codec/framemeta.py``.  The batched
decode wants pure data-parallel work, so the tiny variable-length frame
headers (AlacFile.cs:435-464,599-632) are parsed on the host
(``codec/framemeta_vec.py``) into NumPy arrays, one lane per frame, any
mix of files, bit depths and channel shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FrameBatch:
    """Per-lane decode parameters + packed payload words (all NumPy)."""

    words: np.ndarray  # (B, W) uint32 big-endian packed payloads
    is_stereo: np.ndarray  # (B,) bool — element tag 1 vs 0
    is_compressed: np.ndarray  # (B,) bool
    n_samples: np.ndarray  # (B,) int32 — outputsamples (hassize-aware)
    sample_size: np.ndarray  # (B,) int32 — cookie bits/sample
    ub: np.ndarray  # (B,) int32 — uncompressedBytes (extra-bits bytes)
    rss: np.ndarray  # (B,) int32 — readsamplesize
    interlacing_shift: np.ndarray  # (B,) int32
    interlacing_leftweight: np.ndarray  # (B,) int32
    payload_pos: np.ndarray  # (B,) int32 — bitpos of extra-bits / raw PCM
    entropy_pos: np.ndarray  # (B,) int32 — bitpos of channel-A Rice data
    order: np.ndarray  # (B, 2) int32
    quant: np.ndarray  # (B, 2) int32
    rice_mult: np.ndarray  # (B, 2) int32 — ricemod * (historymult/4)
    rc: np.ndarray  # (B, 2, 32) int32 — base-aligned reversed coefs
    kmod: np.ndarray  # (B,) int32 — cookie rice_kmodifier
    init_history: np.ndarray  # (B,) int32 — cookie rice_initialhistory
    kmask: np.ndarray  # (B,) int32 — (1<<kmod)-1
    #: Per-frame parse status: 0 ok, 1 bad channel tag, 2 bad prediction
    #: type (a malformed frame poisons only its lane in lenient mode).
    status: np.ndarray = None

    @property
    def batch(self) -> int:
        return int(self.words.shape[0])
