"""PCM byte formatting and WAV output.

A copy of ``alacnet_tpu/pcm.py`` (host code, no JAX in it; the port
copies its host tier instead of importing it).  Vectorized replacement
for ``FormatSamples`` (AlacContext.cs:214-256): int sample arrays ->
little-endian PCM bytes for 8/16/24-bit, plus a
minimal RIFF/WAVE writer (the demo-playback analog: the reference plays
through NAudio, we decode to WAV).
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from .errors import UnsupportedFormatError


def format_pcm_bytes(samples: np.ndarray, bytes_per_sample: int) -> bytes:
    """(N, ch) int32 samples -> interleaved little-endian PCM bytes.

    bps=1: offset-binary +128 (AlacContext.cs:222-229);
    bps=2: 16-bit LE (:231-241); bps=3: 24-bit LE (:244-252, where the
    reference's ints already hold bytes — we hold samples and emit the
    identical byte stream).
    """
    flat = np.ascontiguousarray(samples, dtype=np.int32).reshape(-1)
    if bytes_per_sample == 1:
        return ((flat + 128) & 0xFF).astype(np.uint8).tobytes()
    if bytes_per_sample == 2:
        return flat.astype("<i2").tobytes()
    if bytes_per_sample == 3:
        u = (flat & 0xFFFFFF).astype(np.uint32)
        out = np.empty((flat.size, 3), dtype=np.uint8)
        out[:, 0] = u & 0xFF
        out[:, 1] = (u >> 8) & 0xFF
        out[:, 2] = (u >> 16) & 0xFF
        return out.tobytes()
    raise UnsupportedFormatError(f"unsupported bytes-per-sample {bytes_per_sample}")


def parse_pcm_bytes(data: bytes, bytes_per_sample: int, channels: int) -> np.ndarray:
    """Inverse of :func:`format_pcm_bytes` -> (N, ch) int32."""
    if bytes_per_sample == 1:
        flat = np.frombuffer(data, np.uint8).astype(np.int32) - 128
    elif bytes_per_sample == 2:
        flat = np.frombuffer(data, "<i2").astype(np.int32)
    elif bytes_per_sample == 3:
        b = np.frombuffer(data, np.uint8).reshape(-1, 3).astype(np.int32)
        flat = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        flat = np.where(flat >= 1 << 23, flat - (1 << 24), flat)
    else:
        raise UnsupportedFormatError(f"unsupported bytes-per-sample {bytes_per_sample}")
    return flat.reshape(-1, channels)


def write_wav(
    out: BinaryIO,
    pcm: bytes | np.ndarray,
    sample_rate: int,
    bits_per_sample: int,
    channels: int,
) -> None:
    """Write a PCM RIFF/WAVE file (integer formats, 8/16/24-bit)."""
    bps = -(-bits_per_sample // 8)
    if isinstance(pcm, np.ndarray):
        pcm = format_pcm_bytes(pcm, bps)
    block_align = bps * channels
    byte_rate = sample_rate * block_align
    out.write(b"RIFF")
    out.write(struct.pack("<I", 36 + len(pcm)))
    out.write(b"WAVEfmt ")
    out.write(
        struct.pack(
            "<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, block_align, bps * 8
        )
    )
    out.write(b"data")
    out.write(struct.pack("<I", len(pcm)))
    out.write(pcm)


def read_wav(stream: BinaryIO) -> tuple[np.ndarray, int, int]:
    """Minimal WAV reader -> ((N, ch) int32, sample_rate, bits).

    Accepts the integer-PCM files :func:`write_wav` produces (and the
    common superset: extra chunks are skipped).
    """
    if stream.read(4) != b"RIFF":
        raise UnsupportedFormatError("not a RIFF file")
    stream.read(4)
    if stream.read(4) != b"WAVE":
        raise UnsupportedFormatError("not a WAVE file")
    fmt = None
    while True:
        hdr = stream.read(8)
        if len(hdr) < 8:
            raise UnsupportedFormatError("no data chunk")
        tag, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if tag == b"fmt ":
            fmt = stream.read(size)
        elif tag == b"data":
            data = stream.read(size)
            break
        else:
            stream.read(size + (size & 1))
    if fmt is None:
        raise UnsupportedFormatError("no fmt chunk")
    audio_fmt, channels, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_fmt not in (1, 0xFFFE):
        raise UnsupportedFormatError(f"unsupported WAV format {audio_fmt}")
    return parse_pcm_bytes(data, bits // 8, channels), rate, bits
