"""Minimal MP4/QuickTime writer for `.m4a` ALAC files.

The reference has no muxer; this exists so the framework can (a) encode,
and (b) synthesize the hand-crafted container-shape test corpus demanded
by SURVEY.md §4 (mdat-before-moov per QTMovieT.cs:78-93, uniform stsz per
QTMovieT.cs:576-590, multi-entry stsc/stco chunk maps).  Output is shaped
to the *strict* subset the reference parser accepts: minf must be exactly
smhd(16) + dinf + stbl (QTMovieT.cs:258-331), stsd version-1 sound
description with the undocumented extra u16 (QTMovieT.cs:460-462).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Sequence

from ..codec.cookie import MAX_CHANNELS, CodecParams, chan_record


def _atom(tag: str, payload: bytes) -> bytes:
    return struct.pack(">I4s", len(payload) + 8, tag.encode("ascii")) + payload


def _full_atom(tag: str, payload: bytes, version: int = 0, flags: int = 0) -> bytes:
    return _atom(tag, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def build_stsd(params: CodecParams) -> bytes:
    """Sample description atom with the ALAC cookie extension (and, for
    more than two channels, the ``chan`` layout record after it)."""
    ext = params.to_stsd_payload()
    if 2 < params.num_channels_cookie <= MAX_CHANNELS:
        ext += chan_record(params.num_channels_cookie)
    # Version-1 QuickTime sound description, fixed 36-byte part
    # (field layout consumed at QTMovieT.cs:448-473).
    fixed = b"".join(
        (
            b"\x00" * 6,  # reserved
            struct.pack(">H", 1),  # data reference index ("version" at :451)
            struct.pack(">H", 0),  # revision level
            struct.pack(">I", 0),  # vendor
            struct.pack(">H", 0),  # the undocumented extra 16 bits (:461)
            struct.pack(">HH", params.num_channels_cookie, params.sample_size),
            struct.pack(">H", 0),  # compression id
            struct.pack(">H", 0),  # packet size
            struct.pack(">HH", min(params.sample_rate, 0xFFFF), 0),  # 16.16 rate
        )
    )
    entry = _atom("alac", fixed + ext)
    return _full_atom("stsd", struct.pack(">I", 1) + entry)


def build_stbl(
    params: CodecParams,
    frame_sizes: Sequence[int],
    frame_durations: Sequence[int],
    chunk_offsets: Sequence[int],
    stsc_entries: Sequence[tuple[int, int, int]],
    uniform_stsz: bool = False,
) -> bytes:
    """Sample table with run-length-compressed stts."""
    # stts: run-length encode consecutive equal durations (QTMovieT.cs:525-559).
    runs: list[tuple[int, int]] = []
    for d in frame_durations:
        if runs and runs[-1][1] == d:
            runs[-1] = (runs[-1][0] + 1, d)
        else:
            runs.append((1, d))
    stts = _full_atom(
        "stts",
        struct.pack(">I", len(runs))
        + b"".join(struct.pack(">II", c, d) for c, d in runs),
    )
    if uniform_stsz:
        sizes = set(frame_sizes)
        if len(sizes) != 1:
            raise ValueError("uniform stsz requires identical frame sizes")
        stsz = _full_atom(
            "stsz", struct.pack(">II", sizes.pop(), len(frame_sizes))
        )
    else:
        stsz = _full_atom(
            "stsz",
            struct.pack(">II", 0, len(frame_sizes))
            + b"".join(struct.pack(">I", s) for s in frame_sizes),
        )
    stsc = _full_atom(
        "stsc",
        struct.pack(">I", len(stsc_entries))
        + b"".join(struct.pack(">III", f, s, d) for f, s, d in stsc_entries),
    )
    stco = _full_atom(
        "stco",
        struct.pack(">I", len(chunk_offsets))
        + b"".join(struct.pack(">I", o) for o in chunk_offsets),
    )
    return _atom("stbl", build_stsd(params) + stts + stsz + stsc + stco)


def build_moov(
    params: CodecParams,
    total_duration: int,
    frame_sizes: Sequence[int],
    frame_durations: Sequence[int],
    chunk_offsets: Sequence[int],
    stsc_entries: Sequence[tuple[int, int, int]],
    uniform_stsz: bool = False,
) -> bytes:
    rate = params.sample_rate
    mvhd = _full_atom(
        "mvhd",
        struct.pack(
            ">IIII", 0, 0, rate, total_duration
        )  # ctime, mtime, timescale, duration
        + struct.pack(">IH", 0x00010000, 0x0100)  # rate 1.0, volume 1.0
        + b"\x00" * 10  # reserved
        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\x00" * 24  # predefines
        + struct.pack(">I", 2),  # next track id
    )
    tkhd = _full_atom(
        "tkhd",
        struct.pack(">IIIII", 0, 0, 1, 0, total_duration)
        + b"\x00" * 8
        + struct.pack(">HHHH", 0, 0, 0x0100, 0)
        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", 0, 0),
        flags=7,
    )
    mdhd = _full_atom(
        "mdhd",
        struct.pack(">IIIIHH", 0, 0, rate, total_duration, 0x55C4, 0),
    )
    hdlr = _full_atom(
        "hdlr",
        struct.pack(">4s4s", b"\x00" * 4, b"soun")
        + struct.pack(">III", 0, 0, 0)
        + struct.pack(">B", 0),  # empty counted name (QTMovieT.cs:403)
    )
    smhd = _full_atom("smhd", struct.pack(">HH", 0, 0))
    assert len(smhd) == 16  # parser requirement (QTMovieT.cs:274)
    dref = _full_atom(
        "dref", struct.pack(">I", 1) + _full_atom("url ", b"", flags=1)
    )
    dinf = _atom("dinf", dref)
    stbl = build_stbl(
        params,
        frame_sizes,
        frame_durations,
        chunk_offsets,
        stsc_entries,
        uniform_stsz,
    )
    minf = _atom("minf", smhd + dinf + stbl)
    mdia = _atom("mdia", mdhd + hdlr + minf)
    trak = _atom("trak", tkhd + mdia)
    return _atom("moov", mvhd + trak)


FTYP = _atom("ftyp", b"M4A " + struct.pack(">I", 0) + b"M4A mp42isom")


def write_m4a(
    out: BinaryIO,
    params: CodecParams,
    frames: Sequence[bytes],
    frame_durations: Sequence[int],
    frames_per_chunk: int = 5,
    mdat_first: bool = False,
    uniform_stsz: bool = False,
    free_padding: int = 0,
    chunk_gap: int = 0,
) -> None:
    """Assemble a complete .m4a file from coded ALAC frames.

    ``mdat_first=True`` writes mdat before moov, exercising the saved-
    position rewind path (QTMovieT.cs:78-93,736-751). ``free_padding``
    inserts a 'free' atom at the top level (skipped at QTMovieT.cs:95-98).
    ``chunk_gap`` inserts dead bytes between chunks inside mdat — a legal
    layout that the table-driven reader handles but the reference's
    sequential mdat reads (AlacContext.cs:195) cannot.
    """
    frame_sizes = [len(f) for f in frames]
    total_duration = int(sum(frame_durations))
    nchunks = max(1, -(-len(frames) // frames_per_chunk))
    gap = b"\xee" * chunk_gap
    chunks = []
    for i in range(nchunks):
        lo = i * frames_per_chunk
        hi = min(lo + frames_per_chunk, len(frames))
        chunks.append(b"".join(frames[lo:hi]))
    mdat_payload = gap.join(chunks) if chunk_gap else b"".join(chunks)
    mdat = _atom("mdat", mdat_payload)
    free = _atom("free", b"\x00" * free_padding) if free_padding else b""

    stsc_entries = [(1, frames_per_chunk, 1)]
    last = len(frames) - frames_per_chunk * (nchunks - 1)
    if nchunks > 1 and last != frames_per_chunk:
        stsc_entries.append((nchunks, last, 1))

    def chunk_offsets(mdat_payload_pos: int) -> list[int]:
        offs = []
        pos = mdat_payload_pos
        for i in range(nchunks):
            offs.append(pos)
            pos += len(chunks[i]) + chunk_gap
        return offs

    if mdat_first:
        payload_pos = len(FTYP) + len(free) + 8
        moov = build_moov(
            params,
            total_duration,
            frame_sizes,
            frame_durations,
            chunk_offsets(payload_pos),
            stsc_entries,
            uniform_stsz,
        )
        out.write(FTYP + free + mdat + moov)
    else:
        # moov size doesn't depend on offsets' values (fixed-width u32s)
        probe = build_moov(
            params,
            total_duration,
            frame_sizes,
            frame_durations,
            [0] * nchunks,
            stsc_entries,
            uniform_stsz,
        )
        payload_pos = len(FTYP) + len(free) + len(probe) + 8
        moov = build_moov(
            params,
            total_duration,
            frame_sizes,
            frame_durations,
            chunk_offsets(payload_pos),
            stsc_entries,
            uniform_stsz,
        )
        assert len(moov) == len(probe)
        out.write(FTYP + free + moov + mdat)
