"""The port's int32 bit primitives against the JAX package's, on edge values.

Exact equality: the codec is integer code and bit-exact by contract.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.ops import bitops as jb  # noqa: E402
from alacnet_tpu_torch.ops import bitops as tb  # noqa: E402

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
EDGES = np.array(
    [0, 1, -1, 2, -2, 3, 7, 8, 15, 16, 255, 256, 0xFFFF, 0x10000,
     0x7FFF, -0x8000, I32_MAX, I32_MIN, I32_MAX - 1, I32_MIN + 1,
     0x12345678, -0x12345678, 1 << 23, -(1 << 23), 0x00FFFFFF, -5, -7],
    np.int32,
)


def _values(seed=0):
    rng = np.random.default_rng(seed)
    rand = rng.integers(I32_MIN, I32_MAX, 64, dtype=np.int64).astype(np.int32)
    return np.concatenate([EDGES, rand])


def _jax(fn, *args):
    return np.asarray(fn(*(jnp.asarray(a) for a in args)))


def _torch(fn, *args):
    return fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args)).numpy()


def _grid(counts):
    v = _values()
    x = np.repeat(v, len(counts))
    n = np.tile(np.asarray(counts, np.int32), len(v))
    return x, n


@pytest.mark.parametrize(
    "name", ["clz32", "trunc_div2_plus1", "sign_i32"]
)
def test_unary(name):
    x = _values()
    np.testing.assert_array_equal(
        _torch(getattr(tb, name), x), _jax(getattr(jb, name), x)
    )


def test_trunc_div_const():
    x = _values()
    for d in (1, 2, 3, 64, 1000):
        want = np.asarray(jb.trunc_div_const(jnp.asarray(x), d))
        got = tb.trunc_div_const(torch.from_numpy(x), d).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"d={d}")


def test_clz32_zero_is_40():
    assert int(tb.clz32(torch.zeros(1, dtype=torch.int32))[0]) == 40


@pytest.mark.parametrize(
    "name,counts",
    [
        # Counts at 0 and 31, and 32+ / negative where jax.lax defines
        # them (shl gives 0, sra gives the sign fill).
        ("shl", [0, 1, 8, 23, 31, 32, 33, 40, -1]),
        ("sra", [0, 1, 9, 31, 32, 33, 40, -1]),
        ("lsr", [0, 1, 9, 23, 31]),
        ("signext", [1, 8, 16, 17, 24, 25, 31, 32]),
    ],
)
def test_shifts(name, counts):
    x, n = _grid(counts)
    np.testing.assert_array_equal(
        _torch(getattr(tb, name), x, n), _jax(getattr(jb, name), x, n)
    )


def test_int32_wraparound_matches():
    """Products and sums wrap like the JAX arrays."""
    x = _values(1)
    y = _values(2)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal((tx * ty).numpy(), np.asarray(jnp.asarray(x) * jnp.asarray(y)))
    np.testing.assert_array_equal((tx + ty).numpy(), np.asarray(jnp.asarray(x) + jnp.asarray(y)))
    np.testing.assert_array_equal((tx - ty).numpy(), np.asarray(jnp.asarray(x) - jnp.asarray(y)))
