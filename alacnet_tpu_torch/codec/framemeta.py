"""Host-side per-lane frame parameters: the :class:`FrameBatch`.

The counterpart of ``alacnet_tpu/codec/framemeta.py``.  The batched
decode wants pure data-parallel work, so the tiny variable-length frame
headers (AlacFile.cs:435-464,599-632) are parsed on the host into NumPy
arrays, one lane per frame, any mix of files, bit depths and channel
shapes: here one frame at a time (:func:`parse_frame_headers`, the
reference parser), in production with array ops or the native tier
(``codec/framemeta_vec.py``, its drop-in twin).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..errors import UnsupportedFormatError
from ..ops.bitreader import pack_frames_to_words
from ..ops.lpc import MAX_ORDER, reverse_coefs
from .cookie import MAX_CHANNELS, CodecParams
from .scalar import BitReader


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
    #: (B, 3) int32 — the cookie's channel count (0 read as 2), history
    #: multiplier / 4 and frame length.  Above 2 channels a frame is a
    #: chain of elements (``cookie.CHANNEL_ELEMENTS``): the fields above
    #: are its first element's, and the device parses the others from
    #: these (``ops/cuda/elem_head.py``).
    chain: np.ndarray = None

    @property
    def batch(self) -> int:
        return int(self.words.shape[0])

    @property
    def max_samples(self) -> int:
        return int(self.n_samples.max()) if self.batch else 0


def chain_columns(channels, hist_mult4, frame_samples) -> np.ndarray:
    """``FrameBatch.chain`` from each frame's cookie channel count (0
    read as 2, as ``StreamInfo.num_channels_or_default``), history
    multiplier / 4 and frame length; raises ``UnsupportedFormatError``
    above ``cookie.MAX_CHANNELS`` channels."""
    ch = np.asarray(channels, np.int32)
    ch = np.where(ch == 0, 2, ch)
    if (ch > MAX_CHANNELS).any():
        raise UnsupportedFormatError(
            f"{int(ch.max())} channels: ALAC has at most {MAX_CHANNELS}")
    return np.stack([ch, np.broadcast_to(hist_mult4, ch.shape),
                     np.broadcast_to(frame_samples, ch.shape)], axis=1).astype(np.int32)


def check_first_element(channels, is_stereo, status, strict: bool) -> np.ndarray:
    """Status 1 for a frame of 3 or more channels whose first element is
    not the single channel its channel map starts with; raises instead
    under ``strict``."""
    bad = (channels > 2) & np.asarray(is_stereo, bool) & (np.asarray(status) == 0)
    if bad.any():
        if strict:
            raise UnsupportedFormatError(
                "a frame of 3 or more channels must start with a single-channel "
                "element (ALACEncoder.cpp sChannelMaps)")
        status = np.where(bad, 1, status).astype(np.int32)
    return status


def parse_frame_headers(
    payloads: list[bytes],
    params_per_frame: list[CodecParams] | CodecParams,
    max_bytes: int | None = None,
) -> FrameBatch:
    """Parse every frame's header, one frame at a time with the scalar
    ``BitReader``; raise on undecodable shapes.

    Mirrors the header portion of DecodeFrame (AlacFile.cs:435-475,
    577-632) and rejects exactly what the reference rejects: channel tags
    > 1, prediction types != 0, sample sizes other than 16/24.
    """
    B = len(payloads)
    if isinstance(params_per_frame, CodecParams):
        params_per_frame = [params_per_frame] * B

    def z32():
        return np.zeros(B, dtype=np.int32)

    is_stereo = np.zeros(B, dtype=bool)
    is_compressed = np.zeros(B, dtype=bool)
    n_samples, sample_size, ub, rss = z32(), z32(), z32(), z32()
    ishift, ilw, payload_pos, entropy_pos = z32(), z32(), z32(), z32()
    kmod, init_history, kmask = z32(), z32(), z32()
    order = np.zeros((B, 2), dtype=np.int32)
    quant = np.zeros((B, 2), dtype=np.int32)
    rice_mult = np.zeros((B, 2), dtype=np.int32)
    raw_coefs = np.zeros((B, 2, MAX_ORDER), dtype=np.int32)

    for b, (payload, p) in enumerate(zip(payloads, params_per_frame)):
        if p.sample_size not in (16, 24):
            raise UnsupportedFormatError(
                f"FIXME: unimplemented sample size {p.sample_size}"
            )
        r = BitReader(payload)
        tag = r.readbits(3)
        if tag not in (0, 1):
            raise UnsupportedFormatError(
                f"unsupported frame channel tag {tag} (AlacFile.cs:435-437)"
            )
        stereo = tag == 1
        r.readbits(4)
        r.readbits(12)
        hassize = r.readbits(1)
        u = r.readbits(2)
        notcomp = r.readbits(1)
        n = r.readbits(32) if hassize else p.max_samples_per_frame
        is_stereo[b] = stereo
        is_compressed[b] = notcomp == 0
        n_samples[b] = n
        sample_size[b] = p.sample_size
        kmod[b] = p.rice_kmodifier
        init_history[b] = p.rice_initial_history
        kmask[b] = p.rice_kmodifier_mask
        if notcomp == 0:
            ub[b] = u
            rss[b] = p.sample_size - 8 * u + (1 if stereo else 0)
            if stereo:
                ishift[b] = r.readbits(8)
                ilw[b] = r.readbits(8)
            else:
                # Mono: 16 unexplained bits before the prediction header
                # (AlacFile.cs:457-459).
                r.readbits(8)
                r.readbits(8)
            for c in range(2 if stereo else 1):
                ptype = r.readbits(4)
                if ptype != 0:
                    # The reference throws for stereo (AlacFile.cs:650,660)
                    # and emits stale data for mono (:488-496); both are
                    # rejected here.
                    raise UnsupportedFormatError(
                        f"FIXME: unhandled prediction type: {ptype}"
                    )
                quant[b, c] = r.readbits(4)
                ricemod = r.readbits(3)
                order[b, c] = r.readbits(5)
                rice_mult[b, c] = ricemod * (p.rice_history_mult // 4)
                for j in range(order[b, c]):
                    v = r.readbits(16)
                    raw_coefs[b, c, j] = v - 65536 if v > 32767 else v
            payload_pos[b] = r.bitpos
            nch = 2 if stereo else 1
            entropy_pos[b] = r.bitpos + n * (8 * u) * nch
        else:
            # Raw PCM: ub forced to 0, no decorrelation
            # (AlacFile.cs:525,697-699).
            rss[b] = p.sample_size + (1 if stereo else 0)
            payload_pos[b] = r.bitpos
            entropy_pos[b] = r.bitpos

    rc = np.stack(
        [reverse_coefs(raw_coefs[:, c], order[:, c]) for c in range(2)], axis=1
    )
    chain = chain_columns([p.num_channels_cookie for p in params_per_frame],
                          [p.rice_history_mult // 4 for p in params_per_frame],
                          [p.max_samples_per_frame for p in params_per_frame])
    status = check_first_element(chain[:, 0], is_stereo, np.zeros(B, np.int32), True)
    return FrameBatch(
        words=pack_frames_to_words(payloads, max_bytes),
        is_stereo=is_stereo,
        is_compressed=is_compressed,
        n_samples=n_samples,
        sample_size=sample_size,
        ub=ub,
        rss=rss,
        interlacing_shift=ishift,
        interlacing_leftweight=ilw,
        payload_pos=payload_pos,
        entropy_pos=entropy_pos,
        order=order,
        quant=quant,
        rice_mult=rice_mult,
        rc=rc,
        kmod=kmod,
        init_history=init_history,
        kmask=kmask,
        status=status,
        chain=chain,
    )
