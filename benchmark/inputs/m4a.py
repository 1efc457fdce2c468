"""The `.m4a` container, frozen for the benchmark.

A copy of the port's ``container/mux.write_m4a`` (moov first, five frames
a chunk, a table entry per frame) and of ``codec/cookie.default_cookie``,
so that the library and the encode reference keep their bytes whatever
later changes the port.  It imports nothing of the port.
"""

from __future__ import annotations

import struct

import numpy as np

_PARAMS = struct.Struct(">IBBBBBBHIII")


def cookie(sample_rate: int, sample_size: int, num_channels: int,
           max_samples_per_frame: int) -> bytes:
    """The stsd 'alac' extension (36 bytes) with Apple's standard tuning:
    history mult 0x28, initial history 0x0a, k modifier 0x0e, max run
    0xff, the worst-case frame size and no average bitrate."""
    max_frame_bytes = ((sample_size + 8) * num_channels * max_samples_per_frame) // 8 + 256
    block = _PARAMS.pack(
        max_samples_per_frame, 0, sample_size, 0x28, 0x0A, 0x0E, num_channels,
        0x00FF, max_frame_bytes, 0, sample_rate,
    )
    return struct.pack(">I4sI", 12 + len(block), b"alac", 0) + block


def _atom(tag: str, payload: bytes) -> bytes:
    return struct.pack(">I4s", len(payload) + 8, tag.encode("ascii")) + payload


def _full_atom(tag: str, payload: bytes, version: int = 0, flags: int = 0) -> bytes:
    return _atom(tag, struct.pack(">B3s", version, flags.to_bytes(3, "big")) + payload)


def _stsd(sample_rate, sample_size, channels, frame_samples) -> bytes:
    fixed = b"".join((
        b"\x00" * 6,
        struct.pack(">H", 1),
        struct.pack(">H", 0),
        struct.pack(">I", 0),
        struct.pack(">H", 0),
        struct.pack(">HH", channels, sample_size),
        struct.pack(">H", 0),
        struct.pack(">H", 0),
        struct.pack(">HH", min(sample_rate, 0xFFFF), 0),
    ))
    ext = cookie(sample_rate, sample_size, channels, frame_samples)
    return _full_atom("stsd", struct.pack(">I", 1) + _atom("alac", fixed + ext))


def _u32s(values) -> bytes:
    return np.asarray(values, ">u4").tobytes()


def _moov(fmt, total, sizes, durations, chunk_offsets, stsc) -> bytes:
    rate = fmt[0]
    runs: list = []
    for d in durations:
        if runs and runs[-1][1] == d:
            runs[-1] = (runs[-1][0] + 1, d)
        else:
            runs.append((1, d))
    stts = _full_atom("stts", struct.pack(">I", len(runs)) + _u32s(
        [x for run in runs for x in run]))
    stsz = _full_atom("stsz", struct.pack(">II", 0, len(sizes)) + _u32s(sizes))
    stsc_atom = _full_atom("stsc", struct.pack(">I", len(stsc)) + _u32s(
        [x for e in stsc for x in e]))
    stco = _full_atom("stco", struct.pack(">I", len(chunk_offsets)) + _u32s(chunk_offsets))
    stbl = _atom("stbl", _stsd(*fmt) + stts + stsz + stsc_atom + stco)
    mvhd = _full_atom(
        "mvhd",
        struct.pack(">IIII", 0, 0, rate, total)
        + struct.pack(">IH", 0x00010000, 0x0100)
        + b"\x00" * 10
        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\x00" * 24
        + struct.pack(">I", 2),
    )
    tkhd = _full_atom(
        "tkhd",
        struct.pack(">IIIII", 0, 0, 1, 0, total)
        + b"\x00" * 8
        + struct.pack(">HHHH", 0, 0, 0x0100, 0)
        + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", 0, 0),
        flags=7,
    )
    mdhd = _full_atom("mdhd", struct.pack(">IIIIHH", 0, 0, rate, total, 0x55C4, 0))
    hdlr = _full_atom(
        "hdlr",
        struct.pack(">4s4s", b"\x00" * 4, b"soun") + struct.pack(">III", 0, 0, 0)
        + struct.pack(">B", 0),
    )
    smhd = _full_atom("smhd", struct.pack(">HH", 0, 0))
    dinf = _atom("dinf", _full_atom("dref", struct.pack(">I", 1) + _full_atom("url ", b"", flags=1)))
    minf = _atom("minf", smhd + dinf + stbl)
    mdia = _atom("mdia", mdhd + hdlr + minf)
    return _atom("moov", mvhd + _atom("trak", tkhd + mdia))


FTYP = _atom("ftyp", b"M4A " + struct.pack(">I", 0) + b"M4A mp42isom")
FRAMES_PER_CHUNK = 5


def write_m4a(sample_rate: int, sample_size: int, channels: int, frame_samples: int,
              frames: list, durations) -> bytes:
    """A whole `.m4a` file: ftyp, moov, then mdat with the coded frames."""
    fmt = (sample_rate, sample_size, channels, frame_samples)
    sizes = [len(f) for f in frames]
    total = int(sum(durations))
    k = FRAMES_PER_CHUNK
    nchunks = max(1, -(-len(frames) // k))
    chunk_sizes = [sum(sizes[i * k : (i + 1) * k]) for i in range(nchunks)]
    stsc = [(1, k, 1)]
    last = len(frames) - k * (nchunks - 1)
    if nchunks > 1 and last != k:
        stsc.append((nchunks, last, 1))
    probe = _moov(fmt, total, sizes, durations, [0] * nchunks, stsc)
    pos = len(FTYP) + len(probe) + 8
    offsets = np.concatenate([[0], np.cumsum(chunk_sizes)[:-1]]) + pos
    moov = _moov(fmt, total, sizes, durations, offsets, stsc)
    payload = b"".join(frames)
    return FTYP + moov + struct.pack(">I4s", len(payload) + 8, b"mdat") + payload
