"""Full batched ALAC frame decode: the device stage, in torch.

The counterpart of ``alacnet_tpu/ops/frame_decode.py``.  It composes the
stages of DecodeFrame (AlacFile.cs:428-719) over a lane-per-frame batch:

    extra-bits extraction  (:476-482,634-641)  — kernel 3, bulk_bits
    Rice + LPC, channel A   (:483,486,643,646)  — kernel 2, rice_lpc
    Rice + LPC, channel B   (:653,656)          — from A's end bit
    raw-PCM path            (:498-526,663-700)  — kernel 3, bulk_bits
    decorrelation + output  (:338-421,527-566)  — elementwise epilogue

Each kernel wrapper runs its plain torch version for CPU tensors.
Which optional stages run (extra bits, channel B, raw frames) is decided
from the host copy of the metadata, never from device values, so no
production batch synchronises the stream.  The entries are
:func:`decode_frames_packed` (the production one: the metadata as one
host matrix) and :func:`decode_frames` (the metadata as
:class:`FrameMetaArrays`); both run :func:`_decode_frames_impl`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.transfer import h2d
from .bitops import I32, shl, signext, sra
from .bitreader import gather_bits
from .cuda.bulk_bits import bulk_bits
from .cuda.rice_lpc import fused_rice_lpc
from .lpc import MAX_ORDER


class FrameMetaArrays(NamedTuple):
    """Device-side view of codec/framemeta.FrameBatch (order matters)."""

    is_stereo: torch.Tensor
    is_compressed: torch.Tensor
    n_samples: torch.Tensor
    sample_size: torch.Tensor
    ub: torch.Tensor
    rss: torch.Tensor
    interlacing_shift: torch.Tensor
    interlacing_leftweight: torch.Tensor
    payload_pos: torch.Tensor
    entropy_pos: torch.Tensor
    order: torch.Tensor  # (B, 2)
    quant: torch.Tensor  # (B, 2)
    rice_mult: torch.Tensor  # (B, 2)
    rc: torch.Tensor  # (B, 2, 32)
    kmod: torch.Tensor
    init_history: torch.Tensor
    kmask: torch.Tensor

    @classmethod
    def host_arrays(cls, fb) -> tuple:
        """Host-side (NumPy) field tuple in declaration order."""
        return (
            np.asarray(fb.is_stereo),
            np.asarray(fb.is_compressed),
            np.asarray(fb.n_samples, dtype=np.int32),
            np.asarray(fb.sample_size, dtype=np.int32),
            np.asarray(fb.ub, dtype=np.int32),
            np.asarray(fb.rss, dtype=np.int32),
            np.asarray(fb.interlacing_shift, dtype=np.int32),
            np.asarray(fb.interlacing_leftweight, dtype=np.int32),
            np.asarray(fb.payload_pos, dtype=np.int32),
            np.asarray(fb.entropy_pos, dtype=np.int32),
            np.asarray(fb.order, dtype=np.int32),
            np.asarray(fb.quant, dtype=np.int32),
            np.asarray(fb.rice_mult, dtype=np.int32),
            np.asarray(fb.rc, dtype=np.int32),
            np.asarray(fb.kmod, dtype=np.int32),
            np.asarray(fb.init_history, dtype=np.int32),
            np.asarray(fb.kmask, dtype=np.int32),
        )

    #: Columns of the packed (B, N_PACKED) int32 transfer layout, the
    #: JAX package's: 10 scalar fields, kmod/init_history/kmask,
    #: order/quant/rice_mult (2 each), rc (2*32).  One matrix = one H2D
    #: copy per batch instead of 17.
    N_PACKED = 13 + 6 + 64

    @classmethod
    def pack_host(cls, fb) -> np.ndarray:
        """FrameBatch -> one (B, N_PACKED) int32 host matrix."""
        h = cls.host_arrays(fb)
        B = h[0].shape[0]
        out = np.empty((B, cls.N_PACKED), np.int32)
        for i in range(10):  # is_stereo .. entropy_pos
            out[:, i] = h[i]
        out[:, 10] = h[14]  # kmod
        out[:, 11] = h[15]  # init_history
        out[:, 12] = h[16]  # kmask
        out[:, 13:15] = h[10]  # order
        out[:, 15:17] = h[11]  # quant
        out[:, 17:19] = h[12]  # rice_mult
        out[:, 19:83] = h[13].reshape(B, 64)  # rc
        return out

    @classmethod
    def unpack(cls, packed: torch.Tensor) -> "FrameMetaArrays":
        """Field views of a packed (B, N_PACKED) int32 tensor.

        The matrix is transposed once, so every (B,) field, and each
        channel's column of the (B, 2) fields, is a contiguous row.
        """
        B = packed.shape[0]
        pt = packed.t().contiguous()
        return cls(
            is_stereo=pt[0] != 0,
            is_compressed=pt[1] != 0,
            n_samples=pt[2],
            sample_size=pt[3],
            ub=pt[4],
            rss=pt[5],
            interlacing_shift=pt[6],
            interlacing_leftweight=pt[7],
            payload_pos=pt[8],
            entropy_pos=pt[9],
            order=pt[13:15].t(),
            quant=pt[15:17].t(),
            rice_mult=pt[17:19].t(),
            rc=pt[19:83].reshape(2, 32, B).permute(2, 0, 1),
            kmod=pt[10],
            init_history=pt[11],
            kmask=pt[12],
        )

    @classmethod
    def from_packed(cls, packed: np.ndarray, device) -> "FrameMetaArrays":
        """One H2D copy of the host matrix ``pack_host`` builds, unpacked."""
        return cls.unpack(h2d(np.asarray(packed, np.int32), torch.device(device)))

    @classmethod
    def from_batch(cls, fb, device) -> "FrameMetaArrays":
        """A FrameBatch's fields as tensors on ``device``, one copy each."""
        dev = torch.device(device)
        return cls(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in cls.host_arrays(fb)))

    def pack(self) -> torch.Tensor:
        """The ``pack_host`` layout of these fields, (B, N_PACKED) int32
        on their device."""
        B = self.n_samples.shape[0]
        cols = (*self[:10], self.kmod, self.init_history, self.kmask,
                self.order, self.quant, self.rice_mult, self.rc)
        return torch.cat([c.to(I32).reshape(B, -1) for c in cols], dim=1)


def _extra_bits(words, m: FrameMetaArrays, S: int):
    """Extra-bits side channel, interleaved A,B per sample (:634-641).

    The JAX package's XLA formulation, kept as the reference that
    kernel 3's extra-bits use is held against."""
    B = words.shape[0]
    ub8 = m.ub * 8
    nch = 1 + m.is_stereo.to(I32)
    stride = (ub8 * nch)[:, None]
    idx = torch.arange(S, dtype=I32, device=words.device)[None, :]
    pos_a = m.payload_pos[:, None] + idx * stride
    nb = torch.clamp(ub8, min=8)[:, None]
    extra_a = gather_bits(words, pos_a, nb)
    extra_b = gather_bits(words, pos_a + ub8[:, None], nb)
    valid = (m.ub > 0)[:, None]
    zero = torch.zeros((B, S), dtype=I32, device=words.device)
    return (
        torch.where(valid, extra_a, zero),
        torch.where(valid & m.is_stereo[:, None], extra_b, zero),
    )


def _extend_raw(v, m: FrameMetaArrays):
    """Raw-sample sign extension: plain for ss<=16, the reference's
    hard-coded 24-bit (x ^ m) - m form for ss>16 (:512-521)."""
    ss = m.sample_size
    le16 = signext(v, ss[:, None])
    mbit = 1 << 23
    gt16 = ((v & 0xFFFFFF) ^ mbit) - mbit
    return torch.where((ss <= 16)[:, None], le16, gt16)


def _raw_pcm(words, m: FrameMetaArrays, S: int):
    """Uncompressed frame bodies (:500-524,665-696), the JAX package's
    XLA formulation, kept as the reference for kernel 3's raw use."""
    ss = m.sample_size
    nch = 1 + m.is_stereo.to(I32)
    stride = (ss * nch)[:, None]
    idx = torch.arange(S, dtype=I32, device=words.device)[None, :]
    pos_a = m.payload_pos[:, None] + idx * stride
    raw_a = gather_bits(words, pos_a, ss[:, None])
    raw_b = gather_bits(words, pos_a + ss[:, None], ss[:, None])
    return _extend_raw(raw_a, m), _extend_raw(raw_b, m)


def decode_frames_packed(
    words: torch.Tensor,
    packed_meta: np.ndarray,
    num_samples: int,
    emit16: bool = False,
    kernel: str = "auto",
):
    """Decode a frame batch -> (samples (B, S, 2), n (B,) int32).

    ``words``: (B, W) int32 word rows on the decode device;
    ``packed_meta``: the host (B, 83) int32 matrix of
    ``FrameMetaArrays.pack_host`` — it is copied to the device once,
    and its host copy decides which optional stages run.

    Output samples are final PCM integers (decorrelated, extra-bits
    merged, sign-extended); channel 1 is zero for mono lanes and samples
    at i >= n are zero.  ``emit16`` returns int16 samples (valid only
    when every lane is a 16-bit stream).
    """
    pm = np.asarray(packed_meta, np.int32)
    m = FrameMetaArrays.from_packed(pm, words.device)
    return _decode_frames_impl(words, m, pm, num_samples, emit16, kernel)[:2]


def decode_frames(
    words: torch.Tensor,
    meta: FrameMetaArrays,
    num_samples: int,
    emit16: bool = False,
    kernel: str = "auto",
    return_ends: bool = False,
):
    """:func:`decode_frames_packed` with the metadata as
    :class:`FrameMetaArrays` (``FrameMetaArrays.from_batch``) on the
    device of ``words``.

    Which stages run is decided on the host, so this makes one host
    copy of the packed metadata: for device tensors that copy waits for
    the stream (a sync).  The production paths stay on
    :func:`decode_frames_packed`, whose metadata starts on the host.
    The CUDA kernels never stall, so no lane reports n = -1.
    ``return_ends`` also returns the bit cursors where channel A's and
    channel B's entropy decodes ended, (end_a, end_b) (B,) int32 each.
    """
    packed = meta.pack()  # on the device; its views are the kernels' layout
    out, n, ends = _decode_frames_impl(words, FrameMetaArrays.unpack(packed),
                                       packed.cpu().numpy(), num_samples, emit16, kernel)
    return (out, n, ends) if return_ends else (out, n)


def _entropy_channels(words, m: FrameMetaArrays, n_a, n_b, S: int, max_order: int,
                      kernel: str, run_b: bool = True):
    """Rice + LPC (kernel 2) of channel A, then of channel B from the bit
    where A ended.  Returns (out_a, out_b, end_a, end_b); without
    ``run_b`` channel B is not decoded, ``out_b`` is None and ``end_b``
    is where it would start."""

    def channel(start, n_ch, c):
        return fused_rice_lpc(
            words, start, n_ch, m.rss, m.kmod, m.init_history,
            m.rice_mult[:, c], m.kmask, m.order[:, c], m.quant[:, c],
            m.rc[:, c].contiguous(), S, max_order=max_order, kernel=kernel,
        )

    out_a, end_a = channel(m.entropy_pos, n_a, 0)
    start_b = torch.clamp(end_a, min=0)
    out_b, end_b = channel(start_b, n_b, 1) if run_b else (None, start_b)
    return out_a, out_b, end_a, end_b


def _decode_frames_impl(words, m: FrameMetaArrays, pm: np.ndarray, num_samples: int,
                        emit16: bool, kernel: str):
    """The decode of both entries: ``m`` the metadata on the device of
    ``words``, ``pm`` its packed host copy, which picks the stages.
    Returns (samples, n, (end_a, end_b)), the last the entropy decodes'
    end bits (:func:`_entropy_channels`)."""
    S = num_samples
    B = words.shape[0]
    dev = words.device
    live_h = np.clip(pm[:, 2], 0, S) > 0
    comp_h = pm[:, 1] != 0
    any_extra = bool(((pm[:, 4] > 0) & comp_h & live_h).any())
    any_b = bool(((pm[:, 0] != 0) & comp_h & live_h).any())
    any_raw = bool((~comp_h & live_h).any())
    orders = pm[:, 13:15][comp_h & live_h].reshape(-1)
    orders = orders[orders != MAX_ORDER]
    max_order = int(orders.max()) if orders.size else 0

    comp = m.is_compressed
    n = torch.clamp(m.n_samples, 0, S)
    n_comp = torch.where(comp, n, 0)
    n_b = torch.where(m.is_stereo, n_comp, 0)

    def zeros():
        return torch.zeros((B, S), dtype=I32, device=dev)

    # ---- extra bits (kernel 3) ----
    if any_extra:
        ub8 = m.ub * 8
        n_eb = torch.where((m.ub > 0) & comp, n, 0)
        extra_a, extra_b, _ = bulk_bits(
            words, m.payload_pos, n_eb, ub8, torch.where(m.is_stereo, ub8, 0),
            S, kernel=kernel,
        )
    else:
        extra_a, extra_b = zeros(), zeros()

    # ---- Rice + LPC (kernel 2), channel B from A's end bit ----
    out_a, out_b, end_a, end_b = _entropy_channels(
        words, m, n_comp, n_b, S, max_order, kernel, run_b=any_b)
    if out_b is None:
        out_b = zeros()

    # ---- raw frames (kernel 3) ----
    if any_raw:
        n_raw = torch.where(comp, 0, n)
        ra, rb, _ = bulk_bits(
            words, m.payload_pos, n_raw, m.sample_size,
            torch.where(m.is_stereo, m.sample_size, 0), S, kernel=kernel,
        )
        raw_a, raw_b = _extend_raw(ra, m), _extend_raw(rb, m)
    else:
        raw_a, raw_b = zeros(), zeros()
    c2 = comp[:, None]
    a = torch.where(c2, out_a, raw_a)
    b = torch.where(c2, out_b, raw_b)

    # ---- decorrelation (:338-421); C# masks shift counts & 31 ----
    lw = torch.where(comp, m.interlacing_leftweight, 0)[:, None]
    sh = torch.where(comp, m.interlacing_shift, 0)[:, None] & 31
    right_w = a - sra(b * lw, sh)
    left_w = right_w + b
    use_w = (lw != 0) & m.is_stereo[:, None]
    left = torch.where(use_w, left_w, a)
    right = torch.where(use_w, right_w, b)

    # ---- extra-bits merge (:381-395,549-554): 24-bit output paths only
    ub8 = torch.where(comp, m.ub * 8, 0)[:, None]
    mask = shl(torch.full_like(ub8, -1), ub8) ^ -1
    has_extra = (ub8 > 0) & (m.sample_size > 16)[:, None]
    left = torch.where(has_extra, shl(left, ub8) | (extra_a & mask), left)
    right = torch.where(
        has_extra & m.is_stereo[:, None], shl(right, ub8) | (extra_b & mask),
        right,
    )

    # 24-bit output is a 3-byte layout (Deinterlace24 truncates each
    # value to its low 24 bits, AlacFile.cs:390-395,558-562).
    is24 = (m.sample_size > 16)[:, None]
    left = torch.where(is24, sra(shl(left, 8), 8), left)
    right = torch.where(is24, sra(shl(right, 8), 8), right)

    # mono lanes: silent channel 1 (:536-540,563-565); mask the tail.
    live = torch.arange(S, dtype=I32, device=dev)[None, :] < n[:, None]
    left = torch.where(live, left, 0)
    right = torch.where(live & m.is_stereo[:, None], right, 0)
    out = torch.stack([left, right], dim=-1)
    if emit16:
        out = out.to(torch.int16)
    return out, n, (end_a, end_b)
