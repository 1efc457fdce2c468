"""Integer/bit primitives with C#-exact int32 semantics, in torch.

The counterpart of ``alacnet_tpu/ops/bitops.py``.  Every helper takes
and returns ``torch.int32`` tensors holding 32-bit patterns (torch has no
shifts, addition or comparison on ``uint32``), and reproduces the
reference's wrapping arithmetic.

torch's own int32 shifts already follow ``jax.lax``: ``<<`` wraps for
counts in [0, 31] and gives 0 outside it, ``>>`` is arithmetic and gives
the sign fill outside [0, 31].  Logical shifts and bit lengths go
through ``int64`` so that the top bit of a pattern never reads as a
sign.
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
_MASK32 = 0xFFFFFFFF


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 by keeping the low 32 bits (two's complement)."""
    return (((x + (1 << 31)) & _MASK32) - (1 << 31)).to(I32)


def u32(x: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int32 bit pattern, as int64."""
    return x.to(I64) & _MASK32


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the 32-bit pattern; **zero gives 40** (the
    reference ladder's fall-through, AlacFile.cs:154-191)."""
    y = u32(x)
    # frexp's exponent is the bit length of an exactly representable
    # integer (every uint32 is exact in float64).
    _, e = torch.frexp(y.to(torch.float64))
    return torch.where(y == 0, 40, 32 - e).to(I32)


def lsr(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of the 32-bit pattern; n in [0, 31]."""
    return wrap32(u32(x) >> n)


def sra(x: torch.Tensor, n) -> torch.Tensor:
    """Arithmetic right shift (C# ``>>`` on int); counts outside [0, 31]
    give the sign fill, as ``jax.lax.shift_right_arithmetic``."""
    return x >> n


def shl(x: torch.Tensor, n) -> torch.Tensor:
    """Left shift with int32 wraparound (C# unchecked ``<<``); counts
    outside [0, 31] give 0, as ``jax.lax.shift_left``."""
    return x << n


def signext(x: torch.Tensor, bits) -> torch.Tensor:
    """Sign-extend the low ``bits`` bits: (x << (32-b)) >> (32-b)."""
    shift = (32 - bits) & 31
    return (x << shift) >> shift


def trunc_div2_plus1(dv: torch.Tensor) -> torch.Tensor:
    """C#-exact (dv + 1) / 2 with truncation toward zero (AlacFile.cs:225)."""
    t = dv + 1
    q = t >> 1
    return torch.where((t < 0) & ((t & 1) != 0), q + 1, q)


def trunc_div_const(x: torch.Tensor, d: int) -> torch.Tensor:
    """C#-exact x / d (truncating) for a positive divisor, with the JAX
    formulation's int32 wrap at ``-INT32_MIN``."""
    return torch.where(x >= 0, x // d, -((-x) // d)).to(I32)


def sign_i32(x: torch.Tensor) -> torch.Tensor:
    """-1/0/+1 of an int32 (the predictor's sign probe, AlacFile.cs:325)."""
    return (x > 0).to(I32) - (x < 0).to(I32)
