"""Kernel 1's plain version and the blob upload, against the JAX package.

``pack_rows_plain`` (the CPU path of the ``pack_rows`` wrapper) against
``pack_rows_xla``, which tests/test_pack_rows.py holds equal to the
Pallas kernel; ``blob_words`` against the JAX ``blob_words``.  Words
compare as int32 bit patterns.  Exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.ops.pallas import pack_rows as jpr  # noqa: E402
from alacnet_tpu_torch.ops.cuda import pack_rows as tpr  # noqa: E402


def _blob(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 1023, 4096, 9998, 10001])
@pytest.mark.parametrize("max_w", [0, 256, 2048])
def test_blob_words_matches(n, max_w):
    blob = _blob(n, n)
    jw32, jtail, jnq = jpr.host_le_words(blob, max_w)
    tw32, ttail, tnq = tpr.host_le_words(blob, max_w)
    np.testing.assert_array_equal(tw32, jw32)
    assert (ttail, tnq) == (jtail, jnq)
    want = np.asarray(jpr.blob_words(blob, max_w=max_w)).view(np.int32)
    got = tpr.blob_words(blob, "cpu", max_w=max_w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _rows_case(seed, B, W, nbytes_blob):
    """Frames packed back to back in a blob, with sub-word offsets, a
    tail frame ending at the blob's last byte and empty frames."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 4 * W - 40, B).astype(np.int64)
    sizes[0] = 0
    offsets = np.sort(rng.integers(0, nbytes_blob - 1, B)).astype(np.int64)
    offsets[-1] = nbytes_blob - sizes[-1]  # tail frame
    offsets[0] &= ~3  # word-aligned empty frame: nbytes = 0
    offsets[1] = offsets[1] | 3  # 3-byte sub-word shift
    sizes = np.minimum(sizes, nbytes_blob - offsets)
    ow, nbytes, bump = tpr.host_row_params(offsets, sizes)
    jow, jnb, jbump = jpr.host_row_params(offsets, sizes)
    np.testing.assert_array_equal(ow, jow)
    np.testing.assert_array_equal(nbytes, jnb)
    np.testing.assert_array_equal(bump, jbump)
    blob = _blob(nbytes_blob, seed + 1)
    max_w = W + 8
    return blob, ow, nbytes, max_w


@pytest.mark.parametrize(
    "seed,B,W,nbytes_blob",
    [(0, 8, 256, 20000), (1, 64, 256, 60000), (2, 24, 512, 7001),
     (3, 16, 256, 1026)],
)
def test_pack_rows_plain_matches_xla(seed, B, W, nbytes_blob):
    blob, ow, nbytes, max_w = _rows_case(seed, B, W, nbytes_blob)
    jb = jpr.blob_words(blob, max_w=max_w)
    want = np.asarray(
        jpr.pack_rows_xla(jb, jnp.asarray(ow), jnp.asarray(nbytes), W)
    ).view(np.int32)
    tb = tpr.blob_words(blob, "cpu", max_w=max_w)
    ow_t, nb_t = torch.from_numpy(ow), torch.from_numpy(nbytes)
    got = tpr.pack_rows(tb, ow_t, nb_t, W)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpr.pack_rows(tb, ow_t, nb_t, W, kernel="torch").numpy(), want
    )
    assert nbytes[0] == 0 and (want[0] == 0).all()


def test_pack_rows_cuda_route_needs_cuda_tensors():
    tb = tpr.blob_words(_blob(100, 0), "cpu", max_w=256)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpr.pack_rows(tb, z, z, 256, kernel="cuda")
    with pytest.raises(ValueError, match="kernel must be"):
        tpr.pack_rows(tb, z, z, 256, kernel="fused")
