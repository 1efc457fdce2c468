"""MSB-first bit writer (encoder counterpart of scalar.BitReader)."""

from __future__ import annotations


class BitWriter:
    """Accumulates big-endian bit fields and pads to a byte boundary."""

    __slots__ = ("_acc", "_nbits", "_out")

    def __init__(self):
        self._acc = 0
        self._nbits = 0
        self._out = bytearray()

    def write(self, value: int, bits: int) -> None:
        """Append the low ``bits`` bits of ``value`` (MSB first)."""
        if bits < 0 or bits > 64:
            raise ValueError(f"bad bit count {bits}")
        value &= (1 << bits) - 1 if bits < 64 else 0xFFFFFFFFFFFFFFFF
        self._acc = (self._acc << bits) | value
        self._nbits += bits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_unary(self, ones: int) -> None:
        """``ones`` 1-bits followed by a terminating 0-bit."""
        for _ in range(ones):
            self.write(1, 1)
        self.write(0, 1)

    @property
    def bitpos(self) -> int:
        return len(self._out) * 8 + self._nbits

    def getvalue(self) -> bytes:
        """Zero-pad to a byte boundary and return the bytes."""
        if self._nbits:
            pad = 8 - self._nbits
            return bytes(self._out) + bytes(
                [(self._acc << pad) & 0xFF]
            )
        return bytes(self._out)
