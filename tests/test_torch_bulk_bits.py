"""Kernel 3's plain version and the port's ``_extra_bits``/``_raw_pcm``
against the JAX package's ``_extra_bits``/``_raw_pcm``.

Inputs are random word rows and per-lane metadata from a numpy seed,
covering 16/24-bit, mono/stereo, ub 1-3 and raw frames; both packages
read them through their own ``FrameMetaArrays.unpack`` of the same
packed matrix.  Exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.ops import frame_decode as jfd  # noqa: E402
from alacnet_tpu.ops.bitreader import gather_bits as jgather_bits  # noqa: E402
from alacnet_tpu_torch.ops import frame_decode as tfd  # noqa: E402
from alacnet_tpu_torch.ops.cuda.bulk_bits import bulk_bits  # noqa: E402

from .test_torch_cuda import (  # noqa: E402
    BULK_KINDS,
    BULK_MALFORMED,
    bulk_bits_case,
    bulk_bits_clipped,
)

B, S = 48, 96


def _case(seed):
    """(words uint32 (B, W), packed meta (B, 83)) with every lane's
    fields inside its row."""
    rng = np.random.default_rng(seed)
    ss = rng.choice([16, 24], B)
    stereo = rng.random(B) < 0.6
    comp = rng.random(B) < 0.6
    ub = np.where(comp, rng.integers(0, 4, B), 0)
    n = rng.integers(0, S + 1, B)
    n[:4] = [0, S, 1, S + 7]  # frozen, full, one, over-long (clipped)
    nch = 1 + stereo
    stride = np.where(comp, ub * 8, ss) * nch
    payload = rng.integers(0, 200, B)
    W = int(((payload + S * stride) // 32).max()) + 8
    words = rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)
    pm = np.zeros((B, 83), np.int32)
    pm[:, 0], pm[:, 1], pm[:, 2], pm[:, 3] = stereo, comp, n, ss
    pm[:, 4] = ub
    pm[:, 8] = payload
    return words, pm


def _both(seed):
    words, pm = _case(seed)
    jm = jfd.FrameMetaArrays.unpack(jnp.asarray(pm))
    tm = tfd.FrameMetaArrays.unpack(torch.from_numpy(pm))
    return words, pm, jm, tm, torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("seed", range(4))
def test_extra_bits_matches(seed):
    words, _, jm, tm, tw = _both(seed)
    ja, jb = jfd._extra_bits(jnp.asarray(words), jm, S)
    ta, tb = tfd._extra_bits(tw, tm, S)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("seed", range(4))
def test_raw_pcm_matches(seed):
    words, _, jm, tm, tw = _both(seed)
    ja, jb = jfd._raw_pcm(jnp.asarray(words), jm, S)
    ta, tb = tfd._raw_pcm(tw, tm, S)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def _live(n, S):
    return np.arange(S)[None, :] < np.clip(n, 0, S)[:, None]


@pytest.mark.parametrize("seed", range(4))
def test_bulk_bits_extra_use_matches_jax(seed):
    """The extra-bits call decode_frames_packed makes, against the JAX
    ``_extra_bits`` on every sample the decode keeps (i < n)."""
    words, pm, jm, tm, tw = _both(seed)
    ja, jb = map(np.asarray, jfd._extra_bits(jnp.asarray(words), jm, S))
    n = torch.clamp(tm.n_samples, 0, S)
    ub8 = tm.ub * 8
    n_eb = torch.where((tm.ub > 0) & tm.is_compressed, n, 0)
    a, b, stalled = bulk_bits(
        tw, tm.payload_pos, n_eb, ub8, torch.where(tm.is_stereo, ub8, 0), S
    )
    assert not stalled.any()
    live = _live(n_eb.numpy(), S)
    np.testing.assert_array_equal(a.numpy(), np.where(live, ja, 0))
    np.testing.assert_array_equal(b.numpy(), np.where(live, jb, 0))


@pytest.mark.parametrize("seed", range(4))
def test_bulk_bits_raw_use_matches_jax(seed):
    """The raw-frame call decode_frames_packed makes (plus the epilogue's
    sign extension), against the JAX ``_raw_pcm`` where i < n."""
    words, pm, jm, tm, tw = _both(seed)
    ja, jb = map(np.asarray, jfd._raw_pcm(jnp.asarray(words), jm, S))
    n = torch.clamp(tm.n_samples, 0, S)
    n_raw = torch.where(tm.is_compressed, 0, n)
    a, b, _ = bulk_bits(
        tw, tm.payload_pos, n_raw, tm.sample_size,
        torch.where(tm.is_stereo, tm.sample_size, 0), S,
    )
    live = _live(n_raw.numpy(), S)
    st = pm[:, 0:1] != 0
    np.testing.assert_array_equal(
        tfd._extend_raw(a, tm).numpy()[live], ja[live]
    )
    np.testing.assert_array_equal(
        tfd._extend_raw(b, tm).numpy()[live & st], jb[live & st]
    )
    assert (b.numpy()[~st[:, 0]] == 0).all()  # n2 == 0: no second field


def _jax_bulk_bits(words, start, n, n1, n2, S):
    """JAX's plain reference of bulk_bits: its XLA gather formulation
    (tests/test_pallas_kernel.py holds the Pallas kernel against it)."""
    w = jnp.asarray(words.view(np.uint32))
    j1 = jnp.asarray(n1)[:, None]
    pos = jnp.asarray(start)[:, None] + (
        jnp.arange(S, dtype=jnp.int32)[None, :] * jnp.asarray(n1 + n2)[:, None]
    )
    live = np.arange(S)[None, :] < n[:, None]
    a = np.where(live, np.asarray(jgather_bits(w, pos, j1)), 0)
    b = np.asarray(jgather_bits(w, pos + j1, jnp.asarray(np.maximum(n2, 1))[:, None]))
    b = np.where(live & (n2 > 0)[:, None], b, 0)
    return a.astype(np.uint32).view(np.int32), b.astype(np.uint32).view(np.int32)


#: The card tests' edge cases where the plain version and the kernel
#: agree (fields in the row; positions that wrap read the same words in
#: both JAX references), minus the 4-byte-offset word table, which only
#: the kernel sees.
PLAIN_KINDS = tuple(k for k in BULK_KINDS if k not in ("clip", "misaligned"))


@pytest.mark.parametrize("S", [1, 7, 33])
@pytest.mark.parametrize("kind", PLAIN_KINDS)
def test_bulk_bits_plain_edges_match_jax(kind, S):
    """The plain bulk_bits at the card tests' edges (a 48-bit stride, one
    field, n = 0 / n < 0 / n > S lanes, int32 wrap, S not a multiple of
    the kernel's 4 samples a thread) against JAX's gather formulation;
    where the fields stay in the row, the card tests' NumPy reference
    (the kernel's per-word clip) equals both."""
    words, start, n, n1, n2 = bulk_bits_case(kind, S)
    T = torch.from_numpy
    a, b, stalled = bulk_bits(T(words), T(start), T(n), T(n1), T(n2), S)
    assert not stalled.any()
    want_a, want_b = _jax_bulk_bits(words, start, n, n1, n2, S)
    np.testing.assert_array_equal(a.numpy(), want_a)
    np.testing.assert_array_equal(b.numpy(), want_b)
    if kind not in BULK_MALFORMED:
        ref_a, ref_b = bulk_bits_clipped(words, start, n, n1, n2, S)
        np.testing.assert_array_equal(ref_a, want_a)
        np.testing.assert_array_equal(ref_b, want_b)
