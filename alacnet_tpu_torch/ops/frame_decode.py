"""Full batched ALAC frame decode: the device stage, in torch.

The counterpart of ``alacnet_tpu/ops/frame_decode.py``.  It composes the
stages of DecodeFrame (AlacFile.cs:428-719) over a lane-per-frame batch:

    extra-bits extraction  (:476-482,634-641)  — kernel 3, bulk_bits
    Rice + LPC, channel A   (:483,486,643,646)  — kernel 2, rice_lpc
    Rice + LPC, channel B   (:653,656)          — from A's end bit
    raw-PCM path            (:498-526,663-700)  — kernel 3, bulk_bits
    decorrelation + output  (:338-421,527-566)  — kernel 7, dec_epilogue

and, for frames of 3-8 channels, the same stages once more for each
later element, whose header kernel 12 (``elem_head``) reads on the
device where the element before it ended (:func:`_element_chain`).
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

from ..errors import UnsupportedFormatError
from ..utils.observability import ELEMENT_CHAIN_SPAN, GLOBAL_STATS, trace_span
from ..utils.transfer import h2d
from .bitops import I32
from .bitreader import gather_bits
from .cuda import elem_head
from .cuda.bulk_bits import bulk_bits
from .cuda.epilogue import decode_epilogue, extend_raw
from .cuda.rice_lpc import fused_rice_lpc, order_bucket
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
        """FrameBatch -> one (B, N_PACKED) int32 host matrix.

        Where the batch holds frames of more than two channels, four
        chain columns follow (``elem_head.N_CHAINED``): each lane's
        elements, the channels of each element of its map
        (``elem_head.ELEMENT_WORDS``; 0 where its frame failed to parse
        or has at most two channels: no element after the first), the
        cookie's history multiplier / 4 and frame length, and the
        output's channels (the batch's widest)."""
        h = cls.host_arrays(fb)
        B = h[0].shape[0]
        chain = getattr(fb, "chain", None)  # None: a batch of one or two channels
        wide = int(chain[:, 0].max()) if chain is not None and B else 0
        out = np.empty((B, cls.N_PACKED if wide <= 2 else elem_head.N_CHAINED), np.int32)
        if wide > 2:
            out[:, elem_head.COL_ELEMENTS] = np.where(
                fb.status == 0, elem_head.ELEMENT_WORDS[chain[:, 0]], 0)
            out[:, elem_head.COL_HIST_MULT4] = chain[:, 1]
            out[:, elem_head.COL_FRAME] = chain[:, 2]
            out[:, elem_head.COL_OUT_CHANNELS] = wide
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
        return cls.from_rows(packed.t().contiguous())

    @classmethod
    def from_rows(cls, pt: torch.Tensor, flags: torch.Tensor | None = None) -> "FrameMetaArrays":
        """Field views of the transposed layout, (>= N_PACKED, B) int32
        rows; ``flags``: (2, B) bool is_stereo and is_compressed, where
        they exist already (``elem_head``)."""
        B = pt.shape[1]
        return cls(
            is_stereo=pt[0] != 0 if flags is None else flags[0],
            is_compressed=pt[1] != 0 if flags is None else flags[1],
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
        return cls.from_rows(cls.rows_from_packed(packed, device))

    @staticmethod
    def rows_from_packed(packed: np.ndarray, device) -> torch.Tensor:
        """One H2D copy of the host matrix ``pack_host`` builds, as its
        transposed rows on ``device``."""
        with trace_span("alac.host.h2d"):
            return h2d(np.asarray(packed, np.int32), torch.device(device)).t().contiguous()

    @classmethod
    def from_batch(cls, fb, device) -> "FrameMetaArrays":
        """A FrameBatch's fields as tensors on ``device``, one copy each.
        Frames of 3 or more channels are refused: their later elements
        are parsed on the device by ``decode_frames_packed``."""
        chain = getattr(fb, "chain", None)
        if chain is not None and (chain[:, 0] > 2).any():
            raise UnsupportedFormatError(
                "frames of 3 or more channels decode through decode_frames_packed")
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
    """Raw-sample sign extension (``epilogue.extend_raw``) with the
    lanes' sample sizes from ``m``."""
    return extend_raw(v, m.sample_size)


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
    """Decode a frame batch -> (samples (B, S, C), n (B,) int32).

    ``words``: (B, W) int32 word rows on the decode device;
    ``packed_meta``: the host (B, 83) int32 matrix of
    ``FrameMetaArrays.pack_host`` ((B, 87) with the chain columns of
    frames of 3-8 channels) — it is copied to the device once, and its
    host copy decides which optional stages run.

    Output samples are final PCM integers (decorrelated, extra-bits
    merged, sign-extended); C is 2, or the batch's widest frame's
    channel count; channel 1 is zero for mono lanes, channels past a
    lane's own are zero, and samples at i >= n are zero.  ``n`` is -status
    where the element chain refused a frame.  ``emit16`` returns int16 samples (valid only
    when every lane is a 16-bit stream).
    """
    pm = np.asarray(packed_meta, np.int32)
    rows = FrameMetaArrays.rows_from_packed(pm, words.device)
    return _decode_frames_impl(words, FrameMetaArrays.from_rows(rows), pm, num_samples,
                               emit16, kernel, rows)[:2]


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

    out_a, end_a = _rice_lpc(words, m, m.entropy_pos, n_a, 0, S, max_order, kernel)
    start_b = torch.clamp(end_a, min=0)
    out_b, end_b = (_rice_lpc(words, m, start_b, n_b, 1, S, max_order, kernel) if run_b
                    else (None, start_b))
    return out_a, out_b, end_a, end_b


def _rice_lpc(words, m: FrameMetaArrays, start, n, c: int, S: int, max_order: int,
              kernel: str):
    """Rice + LPC (kernel 2) of channel ``c`` of each lane's element."""
    return fused_rice_lpc(
        words, start, n, m.rss, m.kmod, m.init_history, m.rice_mult[:, c], m.kmask,
        m.order[:, c], m.quant[:, c], m.rc[:, c].contiguous(), S, max_order=max_order,
        kernel=kernel,
    )


def _decode_frames_impl(words, m: FrameMetaArrays, pm: np.ndarray, num_samples: int,
                        emit16: bool, kernel: str, rows=None):
    """The decode of both entries: ``m`` the metadata on the device of
    ``words``, ``pm`` its packed host copy, which picks the stages.
    Returns (samples, n, (end_a, end_b)), the last the entropy decodes'
    end bits (:func:`_entropy_channels`) of each frame's first element.
    Where ``pm`` has the chain columns (``pack_host``), ``rows`` are its
    transposed rows on the device and the frames' later elements follow
    (:func:`_element_chain`)."""
    S = num_samples
    chained = pm.shape[1] > FrameMetaArrays.N_PACKED
    channels = int(pm[0, elem_head.COL_OUT_CHANNELS]) if chained else 2
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

    # ---- extra bits (kernel 3) ----
    extra_a = extra_b = None  # absent planes read as zeros (kernel 7)
    if any_extra:
        ub8 = m.ub * 8
        n_eb = torch.where((m.ub > 0) & comp, n, 0)
        extra_a, extra_b, _ = bulk_bits(
            words, m.payload_pos, n_eb, ub8, torch.where(m.is_stereo, ub8, 0),
            S, kernel=kernel,
        )

    # ---- Rice + LPC (kernel 2), channel B from A's end bit ----
    out_a, out_b, end_a, end_b = _entropy_channels(
        words, m, n_comp, n_b, S, max_order, kernel, run_b=any_b)

    # ---- raw frames (kernel 3) ----
    raw_a = raw_b = None
    if any_raw:
        n_raw = torch.where(comp, 0, n)
        raw_a, raw_b, _ = bulk_bits(
            words, m.payload_pos, n_raw, m.sample_size,
            torch.where(m.is_stereo, m.sample_size, 0), S, kernel=kernel,
        )

    # ---- select, decorrelation, extra-bits merge, masks (kernel 7) ----
    out = decode_epilogue(
        out_a, out_b, extra_a, extra_b, raw_a, raw_b, m.is_stereo, comp,
        m.sample_size, m.ub, m.interlacing_shift, m.interlacing_leftweight, n,
        S, emit16=emit16, kernel=kernel, channels=channels,
    )
    GLOBAL_STATS.record_elements(int(live_h.sum()))
    if chained:
        n = _element_chain(words, rows, pm, live_h, out, n, end_a, end_b, S,
                           order_bucket(max_order), emit16, kernel)
    return out, n, (end_a, end_b)


def _element_chain(words, base, pm: np.ndarray, live_h, out, n, end_a, end_b, S: int,
                   bucket: int, emit16: bool, kernel: str):
    """The later elements of frames of 3-8 channels, on the device: for
    each element k >= 1 of the widest frame's channel map, the header
    kernel (``elem_head``) reads element k's header where element k-1
    ended, and its columns feed the stages element 0 ran: one
    ``bulk_bits`` call for its extra bits or raw body (run on every such
    pass, each lane's counts masking it), ``rice_lpc`` for channel A and,
    where the map puts a pair at k, channel B (:func:`_chained_channel`),
    and the epilogue, which writes the element's channels at their offset
    in ``out``.  A last header pass checks the END tag and gives each
    lane's sample count, or -status where the chain refused the frame.
    No pass reads the device from the host, so element k's orders are
    not known there: ``bucket`` is element 0's order bucket.  Returns
    that count (``n``, element 0's, where no frame has a later
    element)."""
    elements = pm[:, elem_head.COL_ELEMENTS]
    nel = elem_head.element_count(elements)
    live = live_h & (nel > 0)
    K = int(nel.max()) if len(nel) else 0
    if not K:
        return n
    GLOBAL_STATS.record_elements(int(nel[live].sum() - live.sum()), passes=K - 1,
                                 multichannel_frames=int(live.sum()))
    prev, status = base, None
    with trace_span(ELEMENT_CHAIN_SPAN):
        for k in range(1, K):
            rows, flags, _ = elem_head.elem_head(words, base, prev, end_a, end_b, status, k,
                                                 S, bucket, kernel=kernel)
            mk = FrameMetaArrays.from_rows(rows, flags)
            any_b = bool((elem_head.element_kind(elements, k) == 2).any())
            plane_a, plane_b, _ = bulk_bits(
                words, mk.payload_pos, rows[elem_head.ROW_BULK_N],
                rows[elem_head.ROW_BULK_N1], rows[elem_head.ROW_BULK_N2], S, kernel=kernel,
            )
            out_a, end_a = _chained_channel(
                words, mk, mk.entropy_pos, rows[elem_head.ROW_N_COMP],
                rows[elem_head.ROW_WIDE_A], flags[2], 0, S, bucket, kernel)
            out_b, end_b = None, torch.clamp(end_a, min=0)
            if any_b:
                out_b, end_b = _chained_channel(
                    words, mk, end_b, rows[elem_head.ROW_N_B], rows[elem_head.ROW_WIDE_B],
                    flags[3], 1, S, bucket, kernel)
            decode_epilogue(
                out_a, out_b, plane_a, plane_b, plane_a, plane_b, mk.is_stereo,
                mk.is_compressed, mk.sample_size, mk.ub, mk.interlacing_shift,
                mk.interlacing_leftweight, mk.n_samples, S, emit16=emit16, kernel=kernel,
                channels=out.shape[2], out=out, channel_offset=rows[elem_head.ROW_COFF],
            )
            prev, status = rows, rows[elem_head.ROW_STATUS]
        _, _, n = elem_head.elem_head(words, base, prev, end_a, end_b, status, K, S,
                                      last=True, kernel=kernel)
    return n


def _chained_channel(words, m: FrameMetaArrays, start, n, n_wide, wide, c: int, S: int,
                     bucket: int, kernel: str):
    """Rice + LPC of channel ``c`` of a later element: the lanes whose
    order fits ``bucket`` (``n``), then, below the widest bucket, those
    whose order is above it (``n_wide``; none in a frame whose elements
    keep to element 0's orders) at the widest, each lane's output and end
    bit taken from the launch that decoded it (``wide``)."""
    out, end = _rice_lpc(words, m, start, n, c, S, bucket, kernel)
    if bucket < MAX_ORDER:
        out_w, end_w = _rice_lpc(words, m, start, n_wide, c, S, MAX_ORDER, kernel)
        out = torch.where(wide[:, None], out_w, out)
        end = torch.where(wide, end_w, end)
    return out, end
