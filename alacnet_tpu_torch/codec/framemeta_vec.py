"""Vectorized (NumPy) frame-header parsing.

The counterpart of ``alacnet_tpu/codec/framemeta_vec.py``: it parses a
whole batch of frame headers with array ops (or with the native C++
tier, ``native.py``) into a :class:`~.framemeta.FrameBatch`.

Header layout being parsed (AlacFile.cs:435-475,577-632):

    tag(3) pad(4) pad(12) hassize(1) ub(2) isnotcompressed(1)
    [hassize: n(32)]
    compressed:
        stereo: shift(8) leftweight(8) | mono: pad(16)
        per channel: ptype(4) quant(4) ricemod(3) order(5) coef(16)*order
"""

from __future__ import annotations

import numpy as np

from ..errors import UnsupportedFormatError
from ..ops.bitreader import WINDOW_PAD, pack_frames_to_words
from ..ops.lpc import MAX_ORDER
from .cookie import CodecParams
from .framemeta import FrameBatch

#: Prefix bytes that always contain the whole header:
#: 23 + 32 + 16 + 2*(16 + 31*16) = 1095 bits -> 137 bytes.
_PREFIX_BYTES = 160
_PREFIX_WORDS = _PREFIX_BYTES // 4 + 2


def _bits(words: np.ndarray, pos: np.ndarray, n) -> np.ndarray:
    """Vectorized big-endian field extraction (words (B, Wp) uint32)."""
    w = np.clip((pos >> 5).astype(np.int64), 0, words.shape[1] - 2)
    sh = (pos & 31).astype(np.uint32)
    hi = np.take_along_axis(words, w[:, None], axis=1)[:, 0]
    lo = np.take_along_axis(words, w[:, None] + 1, axis=1)[:, 0]
    x = (hi << sh) | np.where(sh == 0, 0, lo >> ((32 - sh) & 31))
    n = np.uint32(n) if np.isscalar(n) else n.astype(np.uint32)
    return (x >> ((32 - n) & np.uint32(31))).astype(np.int64)


def parse_frame_headers_vec(
    payloads: list[bytes],
    params_per_frame: list[CodecParams] | CodecParams,
    max_bytes: int | None = None,
    strict: bool = True,
    pack_words: bool = True,
) -> FrameBatch:
    """Vectorized twin of parse_frame_headers (same contract).

    ``strict=False`` records undecodable frames in ``FrameBatch.status``
    (1: channel tag, 2: prediction type) and freezes their lanes
    (n_samples=0) instead of raising — SURVEY.md §5 failure detection.
    """
    B = len(payloads)
    if isinstance(params_per_frame, CodecParams):
        plist = None
        p0 = params_per_frame
        sample_size = np.full(B, p0.sample_size, np.int32)
        kmod = np.full(B, p0.rice_kmodifier, np.int32)
        init_history = np.full(B, p0.rice_initial_history, np.int32)
        hist_mult4 = np.full(B, p0.rice_history_mult // 4, np.int32)
        max_frames = np.full(B, p0.max_samples_per_frame, np.int64)
        if p0.sample_size not in (16, 24):
            raise UnsupportedFormatError(
                f"FIXME: unimplemented sample size {p0.sample_size}"
            )
    else:
        plist = params_per_frame
        sample_size = np.array([p.sample_size for p in plist], np.int32)
        kmod = np.array([p.rice_kmodifier for p in plist], np.int32)
        init_history = np.array([p.rice_initial_history for p in plist], np.int32)
        hist_mult4 = np.array([p.rice_history_mult // 4 for p in plist], np.int32)
        max_frames = np.array([p.max_samples_per_frame for p in plist], np.int64)
        bad = ~np.isin(sample_size, (16, 24))
        if bad.any():
            raise UnsupportedFormatError(
                f"FIXME: unimplemented sample size {sample_size[bad.argmax()]}"
            )

    # Pack the header prefixes into big-endian words.
    prefix = np.zeros((B, _PREFIX_WORDS * 4), np.uint8)
    for i, f in enumerate(payloads):
        n = min(len(f), _PREFIX_WORDS * 4)
        prefix[i, :n] = np.frombuffer(f[:n], np.uint8)
    pw = (
        prefix.reshape(B, _PREFIX_WORDS, 4).astype(np.uint32)
        @ np.array([1 << 24, 1 << 16, 1 << 8, 1], np.uint32)
    )

    pos = np.zeros(B, np.int64)
    tag = _bits(pw, pos, 3)
    status = np.zeros(B, np.int32)
    if (tag > 1).any():
        if strict:
            raise UnsupportedFormatError(
                f"unsupported frame channel tag {int(tag[(tag > 1).argmax()])} "
                "(AlacFile.cs:435-437,577)"
            )
        status[tag > 1] = 1
        tag = np.where(tag > 1, 0, tag)
    is_stereo = tag == 1
    hassize = _bits(pw, pos + 19, 1)
    ub = _bits(pw, pos + 20, 2)
    notcomp = _bits(pw, pos + 22, 1)
    pos = pos + 23
    n_explicit = _bits(pw, pos, 32)
    n_samples = np.where(hassize == 1, n_explicit, max_frames)
    pos = pos + 32 * hassize
    is_compressed = notcomp == 0

    # -- compressed header section (mono also carries 16 filler bits,
    # AlacFile.cs:457-459) --
    ishift = np.where(is_compressed & is_stereo, _bits(pw, pos, 8), 0)
    ilw = np.where(is_compressed & is_stereo, _bits(pw, pos + 8, 8), 0)
    cpos = pos + 16

    order = np.zeros((B, 2), np.int32)
    quant = np.zeros((B, 2), np.int32)
    rice_mult = np.zeros((B, 2), np.int32)
    rc = np.zeros((B, 2, MAX_ORDER + 1), np.int32)
    ptype_bad = np.zeros(B, bool)
    for c in range(2):
        in_ch = is_compressed & (is_stereo if c == 1 else np.ones(B, bool))
        ptype = _bits(pw, cpos, 4)
        ptype_bad |= in_ch & (ptype != 0)
        quant[:, c] = np.where(in_ch, _bits(pw, cpos + 4, 4), 0)
        ricemod = _bits(pw, cpos + 8, 3)
        rice_mult[:, c] = np.where(in_ch, ricemod * hist_mult4, 0)
        o = np.where(in_ch, _bits(pw, cpos + 11, 5), 0).astype(np.int32)
        order[:, c] = o
        coef_pos = cpos + 16
        # Raw 16-bit signed coefficient table (AlacFile.cs:466-475).
        coefval = np.zeros((B, MAX_ORDER), np.int32)
        for j in range(MAX_ORDER):
            v = _bits(pw, coef_pos + 16 * j, 16)
            v = np.where(v > 32767, v - 65536, v)
            coefval[:, j] = np.where(in_ch & (j < o), v, 0)
        # Base-aligned reversed layout rc[t] = coef[order - t] (ops/lpc.py);
        # only used for 0 < order < 31.
        for t in range(1, MAX_ORDER + 1):
            j = o - t
            valid = in_ch & (j >= 0) & (j < o) & (o < MAX_ORDER)
            rc[:, c, t] = np.where(
                valid,
                np.take_along_axis(
                    coefval, np.clip(j, 0, MAX_ORDER - 1)[:, None], axis=1
                )[:, 0],
                0,
            )
        cpos = cpos + np.where(in_ch, 16 + 16 * o, 0)
    if ptype_bad.any():
        if strict:
            raise UnsupportedFormatError(
                "FIXME: unhandled prediction type (AlacFile.cs:650,660)"
            )
        status[ptype_bad] = 2

    payload_pos = np.where(is_compressed, cpos, pos)
    rss = np.where(
        is_compressed,
        sample_size - 8 * ub + is_stereo,
        sample_size + is_stereo,
    )
    ub_eff = np.where(is_compressed, ub, 0)
    nch = 1 + is_stereo.astype(np.int64)
    entropy_pos = payload_pos + np.where(
        is_compressed, n_samples * (8 * ub_eff) * nch, 0
    )

    bad = status != 0
    if bad.any():
        n_samples = np.where(bad, 0, n_samples)
        is_compressed = is_compressed & ~bad
    if pack_words:
        words = pack_frames_to_words(payloads, max_bytes)
    else:
        # Header-only parse (e.g. the order-aware batching pre-pass in
        # parallel/pipeline.decode_blob): words are packed later per span.
        words = np.zeros((B, 0), np.uint32)
    return FrameBatch(
        words=words,
        is_stereo=is_stereo,
        is_compressed=is_compressed,
        n_samples=n_samples.astype(np.int32),
        sample_size=sample_size,
        ub=ub_eff.astype(np.int32),
        rss=rss.astype(np.int32),
        interlacing_shift=ishift.astype(np.int32),
        interlacing_leftweight=ilw.astype(np.int32),
        payload_pos=payload_pos.astype(np.int32),
        entropy_pos=entropy_pos.astype(np.int32),
        order=order,
        quant=quant,
        rice_mult=rice_mult,
        rc=rc,
        kmod=kmod,
        init_history=init_history,
        kmask=((1 << kmod.astype(np.int64)) - 1).astype(np.int32),
        status=status,
    )


def _cookie_arrays(B: int, params_per_frame):
    if isinstance(params_per_frame, CodecParams):
        p = params_per_frame
        return (
            np.full(B, p.sample_size, np.int32),
            np.full(B, p.rice_kmodifier, np.int32),
            np.full(B, p.rice_initial_history, np.int32),
            np.full(B, p.rice_history_mult // 4, np.int32),
            np.full(B, p.max_samples_per_frame, np.int32),
        )
    pl = params_per_frame
    return (
        np.array([p.sample_size for p in pl], np.int32),
        np.array([p.rice_kmodifier for p in pl], np.int32),
        np.array([p.rice_initial_history for p in pl], np.int32),
        np.array([p.rice_history_mult // 4 for p in pl], np.int32),
        np.array([p.max_samples_per_frame for p in pl], np.int32),
    )


def words_width(max_bytes: int, nwords_multiple: int = 8) -> int:
    """Packed word-row width for frames up to ``max_bytes`` coded bytes
    (rounds up and appends the bit-reader's overrun slack)."""
    m = max(8, nwords_multiple)
    return -(-(-(-max_bytes // 4) + WINDOW_PAD) // m) * m


def parse_frame_headers_blob(
    blob: np.ndarray,
    offsets: np.ndarray,
    sizes: np.ndarray,
    params_per_frame: list[CodecParams] | CodecParams,
    max_bytes: int | None = None,
    strict: bool = True,
    nwords_multiple: int = 8,
    pack_words: bool = True,
    native: bool = True,
) -> FrameBatch:
    """Blob-based front door: native C++ pack+parse when available.

    ``blob`` is the raw file (or mdat) bytes as a uint8 array; frames are
    addressed by absolute (offset, size) pairs — no per-frame Python
    slicing.  ``native=False``, or a host without a C++ compiler, takes
    the NumPy parser instead (bit-identical).
    """
    from .. import native as native_tier

    B = len(offsets)
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    ss, km, ih, hm4, ms = _cookie_arrays(B, params_per_frame)
    bad = ~np.isin(ss, (16, 24))
    if bad.any():
        raise UnsupportedFormatError(
            f"FIXME: unimplemented sample size {ss[bad.argmax()]}"
        )
    lib = native_tier.get_lib() if native else None
    parsed = (
        None if lib is None else native_tier.parse_headers_native(
            lib, blob, offsets, sizes, ss, km, ih, hm4, ms
        )
    )
    if parsed is None:
        payloads = [
            blob[o : o + s].tobytes() for o, s in zip(offsets, sizes)
        ]
        return parse_frame_headers_vec(
            payloads, params_per_frame, max_bytes, strict, pack_words
        )
    if parsed["first_bad"] >= 0:
        if strict:
            b = parsed["first_bad"]
            code = int(parsed["status"][b])
            if code == 1:
                raise UnsupportedFormatError(
                    "unsupported frame channel tag (AlacFile.cs:435-437,577)"
                )
            raise UnsupportedFormatError(
                "FIXME: unhandled prediction type (AlacFile.cs:650,660)"
            )
        bad = parsed["status"] != 0
        parsed["n_samples"] = np.where(bad, 0, parsed["n_samples"])
        parsed["is_compressed"] = np.where(bad, 0, parsed["is_compressed"])
    if pack_words:
        if max_bytes is None:
            max_bytes = int(sizes.max()) if B else 0
        nwords = words_width(max_bytes, nwords_multiple)
        words = native_tier.pack_frames_native(lib, blob, offsets, sizes, nwords)
    else:
        words = np.zeros((B, 0), np.uint32)
    return FrameBatch(
        words=words,
        is_stereo=parsed["is_stereo"].astype(bool),
        is_compressed=parsed["is_compressed"].astype(bool),
        n_samples=parsed["n_samples"],
        sample_size=ss,
        ub=parsed["ub"],
        rss=parsed["rss"],
        interlacing_shift=parsed["interlacing_shift"],
        interlacing_leftweight=parsed["interlacing_leftweight"],
        payload_pos=parsed["payload_pos"],
        entropy_pos=parsed["entropy_pos"],
        order=parsed["order"],
        quant=parsed["quant"],
        rice_mult=parsed["rice_mult"],
        rc=parsed["rc"],
        kmod=parsed["kmod"],
        init_history=parsed["init_history"],
        kmask=parsed["kmask"],
        status=parsed["status"],
    )
