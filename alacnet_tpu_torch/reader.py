"""ALACFileReader — streaming seekable wave-stream adapter.

The counterpart of ``alacnet_tpu/reader.py``, the Python analog of the
C# reference's NAudio adapter (ALACFileReader.cs:22-127): exposes
decoded PCM as a byte stream with ``read(count)`` of arbitrary size
(leftover buffering between ALAC frame granularity and the caller's
chunking), byte-addressed ``position`` get/set, ``length``,
``wave_format``, and thread-safe repositioning.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import BinaryIO

from .config import DecodeConfig
from .context import AlacContext


@dataclasses.dataclass(frozen=True)
class WaveFormat:
    """The NAudio WaveFormat fields the adapter exposes (:42)."""

    sample_rate: int
    bits_per_sample: int
    channels: int

    @property
    def block_align(self) -> int:
        return (self.bits_per_sample // 8) * self.channels

    @property
    def average_bytes_per_second(self) -> int:
        return self.sample_rate * self.block_align


class ALACFileReader:
    """Seekable PCM byte stream over an ALAC file.

    ``device``/``config`` pass through to :class:`AlacContext` (default
    ``DecodeConfig()``: decode on ``cuda``, raising without a card).
    """

    def __init__(
        self, stream: BinaryIO, dispose_after_use: bool = False,
        device: str | None = None, config: DecodeConfig | None = None,
    ):
        self._context = AlacContext(
            stream, dispose_after_use, device=device, config=config
        )
        # The reference builds WaveFormat from GetBytesPerSample()*8
        # (ALACFileReader.cs:42) — 24-bit streams report 24.
        self._wave_format = WaveFormat(
            sample_rate=self._context.get_sample_rate(),
            bits_per_sample=self._context.get_bytes_per_sample() * 8,
            channels=self._context.get_num_channels(),
        )
        num = self._context.get_num_samples()
        self._length = max(num, 0) * self._wave_format.block_align
        self._leftover = b""
        self._logical_pos = 0  # true byte cursor (io protocol; the
        # `position` property keeps the reference's LastSampleNumber view)
        self._lock = threading.Lock()

    # -- stream surface (ALACFileReader.cs:58-116) ----------------------------

    @property
    def wave_format(self) -> WaveFormat:
        return self._wave_format

    @property
    def length(self) -> int:
        """Decoded stream length in bytes (:43)."""
        return self._length

    @property
    def total_time(self) -> float:
        """Duration in seconds (WaveStream.TotalTime analog)."""
        return self._length / self._wave_format.average_bytes_per_second

    @property
    def position(self) -> int:
        """Byte position = LastSampleNumber * BlockAlign (:63-65)."""
        return self._context.last_sample_number * self._wave_format.block_align

    @position.setter
    def position(self, value: int) -> None:
        with self._lock:
            self._context.set_position(value // self._wave_format.block_align)
            self._leftover = b""  # drop buffered data on reposition (:71)
            self._logical_pos = int(value)

    @property
    def current_time(self) -> float:
        return self.position / self._wave_format.average_bytes_per_second

    def read(self, count: int) -> bytes:
        """Read up to ``count`` decoded bytes (short only at EOF) (:89-116)."""
        with self._lock:
            chunks = []
            have = 0
            if self._leftover:
                take = min(len(self._leftover), count)
                chunks.append(self._leftover[:take])
                self._leftover = self._leftover[take:]
                have = take
            while have < count:
                unpacked = self._context.read()
                if not unpacked:
                    break
                take = min(len(unpacked), count - have)
                chunks.append(unpacked[:take])
                self._leftover = unpacked[take:]
                have += take
            self._logical_pos += have
            return b"".join(chunks)

    def readinto(self, buffer, offset: int = 0, count: int | None = None) -> int:
        """C#-style Read(buffer, offset, count) (:89)."""
        if count is None:
            count = len(buffer) - offset
        data = self.read(count)
        buffer[offset : offset + len(data)] = data
        return len(data)

    # -- stdlib io protocol (so the reader drops into BufferedReader,
    # shutil.copyfileobj, wave-writer pipelines, ...) --------------------

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def tell(self) -> int:
        return self._logical_pos

    def seek(self, offset: int, whence: int = 0) -> int:
        """Byte seek with os.SEEK_SET/CUR/END semantics.

        Returns the requested position (reads resume exactly there thanks
        to the mid-frame trim); note the ``position`` *property* instead
        reports LastSampleNumber*BlockAlign for reference parity, which
        parks at the bracketing frame's end after a reposition
        (AlacContext.cs:278-283).
        """
        if whence == 0:
            target = offset
        elif whence == 1:
            target = self._logical_pos + offset
        elif whence == 2:
            target = self._length + offset
        else:
            raise ValueError(f"invalid whence {whence}")
        target = max(0, target)
        with self._lock:
            # Unlike the reference-parity position setter, io seek must
            # park at EOF for past-end targets (read() then returns b"").
            self._context.set_position(
                target // self._wave_format.block_align, clamp_to_eof=True
            )
            self._leftover = b""
            self._logical_pos = target
        return target

    def close(self) -> None:
        with self._lock:
            self._context.close()

    def __enter__(self) -> "ALACFileReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
