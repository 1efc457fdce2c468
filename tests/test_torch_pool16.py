"""The PCM dtype of a pooled 16-bit decode, on the CPU at a tiny size.

``decode_streams`` picks each batch's output dtype over its real lanes
(``decode_blob(real_lanes16=True)``), so a 16-bit track whose batches
are padded comes back int16 and its file is a view of the pool.  The
callers whose pool dtype is public (``decode_resumable``,
``AlacContext``, ``decode_blob``'s default) keep the JAX package's rule,
which picks over the padded batch.  Each case resets ``GLOBAL_STATS``
and reads ``int16_batches`` and ``pcm_bytes_back`` after the call.

Frames of 256 samples keep the plain ``rice_lpc`` loops short.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import alacnet_tpu  # noqa: E402
import alacnet_tpu_torch  # noqa: E402
from alacnet_tpu.codec.encoder import EncoderConfig  # noqa: E402
from alacnet_tpu.parallel import pipeline as jpipeline  # noqa: E402
from alacnet_tpu_torch.batch import _pool  # noqa: E402
from alacnet_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from alacnet_tpu_torch.parallel.pipeline import (  # noqa: E402
    BATCH_BUCKETS, decode_blob, plan_blob_batches,
)
from alacnet_tpu_torch.utils.observability import GLOBAL_STATS  # noqa: E402

from .corpus import encode_to_bytes, tone  # noqa: E402

FS = 256  # samples per frame
CPU = alacnet_tpu_torch.DecodeConfig(device="cpu")


def track(frames, channels=2, bits=16, seed=0):
    """(source PCM, .m4a bytes) of ``frames`` frames, the last partial."""
    pcm = tone(FS * (frames - 1) + 9, channels, bits, seed=seed,
               noise=2000.0 if bits == 24 else 60.0)
    return pcm, encode_to_bytes(pcm, 44100, bits, EncoderConfig(order=6),
                                max_samples_per_frame=FS)


def spans(files, limit=CPU.batch_limit):
    """The lane counts of the batches the decode plans for the files."""
    _, _, pooled, params = _pool([io.BytesIO(d) for _, d in files])
    return [hi - lo for lo, hi in plan_blob_batches(*pooled, params, limit, True)[2]]


def decode(files, config=CPU, mesh=None):
    """The port's ``decode_streams`` of the files and the counters after it."""
    GLOBAL_STATS.reset()
    got = alacnet_tpu_torch.decode_streams([io.BytesIO(d) for _, d in files],
                                           config=config, mesh=mesh)
    snap = GLOBAL_STATS.snapshot()
    GLOBAL_STATS.reset()
    return got, snap


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pcm.dtype == w.pcm.dtype
        np.testing.assert_array_equal(g.pcm, w.pcm)
        assert (g.sample_rate, g.bits_per_sample, g.channels) == (
            w.sample_rate, w.bits_per_sample, w.channels)


@pytest.fixture(scope="module")
def mixed():
    """A 16-bit stereo, a 24-bit stereo and a 16-bit mono track in one pool."""
    return [track(5, 2, 16, seed=1), track(4, 2, 24, seed=2), track(6, 1, 16, seed=3)]


@pytest.mark.parametrize("frames", [1, 3, 65, 1030])
def test_padded_16bit_track_comes_back_int16_as_a_view(frames):
    files = [track(frames, seed=frames)]
    assert all(b not in BATCH_BUCKETS for b in spans(files))  # every batch padded
    (got,), snap = decode(files)
    assert got.pcm.dtype == np.int16
    np.testing.assert_array_equal(got.pcm, files[0][0])
    assert snap["int16_batches"] == snap["dispatches"] >= 1
    assert snap["pcm_bytes_back"] == frames * FS * 2 * 2  # the real lanes, 2 B a value
    assert (snap["assembled_files"], snap["assembly_views"]) == (1, 1)
    assert_same([got], alacnet_tpu.decode_streams([io.BytesIO(files[0][1])]))


def test_mixed_pool_matches_jax(mixed):
    got, snap = decode(mixed)
    assert_same(got, alacnet_tpu.decode_streams([io.BytesIO(d) for _, d in mixed]))
    for g, (pcm, _) in zip(got, mixed):
        np.testing.assert_array_equal(g.pcm, pcm)
    # the 16-bit batches come back int16, the 24-bit ones int32
    assert 0 < snap["int16_batches"] < snap["dispatches"]


@pytest.mark.parametrize("pool", ["one16", "mixed"])
def test_mesh_of_three_shards_matches_one_device(pool, mixed):
    files = [track(65, seed=4)] if pool == "one16" else mixed
    one, one_snap = decode(files)
    meshed, snap = decode(files, mesh=Mesh(["cpu"] * 3))
    assert_same(meshed, one)
    assert snap["int16_batches"] == one_snap["int16_batches"]
    assert snap["pcm_bytes_back"] == one_snap["pcm_bytes_back"]
    if pool == "one16":
        assert snap["int16_batches"] == snap["dispatches"]


def test_emit16_off_gives_the_int32_pool():
    files = [track(65, seed=5)]
    (on,), on_snap = decode(files)
    (off,), snap = decode(files, alacnet_tpu_torch.DecodeConfig(device="cpu", emit16=False))
    assert off.pcm.dtype == np.int16  # the file's dtype is its own
    np.testing.assert_array_equal(off.pcm, on.pcm)
    assert snap["int16_batches"] == 0 and snap["assembly_views"] == 0
    assert snap["pcm_bytes_back"] == 2 * on_snap["pcm_bytes_back"]


def test_public_pool_dtype_keeps_the_jax_rule(tmp_path):
    """A padded 16-bit window through ``decode_blob``'s default,
    ``decode_resumable`` and ``AlacContext``: int32, as the JAX package
    gives, where ``real_lanes16`` gives int16."""
    pcm, data = track(5, seed=6)
    path = tmp_path / "t.m4a"
    path.write_bytes(data)
    _, _, (blob, offsets, sizes), params = _pool([io.BytesIO(data)])
    want = jpipeline.decode_blob(blob, offsets, sizes, params, FS)[0]
    assert want.dtype == np.int32
    GLOBAL_STATS.reset()
    out = decode_blob(blob, offsets, sizes, params, FS, config=CPU)[0]
    assert out.dtype == want.dtype and GLOBAL_STATS.int16_batches == 0
    np.testing.assert_array_equal(out, want)
    real = decode_blob(blob, offsets, sizes, params, FS, config=CPU, real_lanes16=True)[0]
    assert real.dtype == np.int16 and GLOBAL_STATS.int16_batches == 1
    np.testing.assert_array_equal(real, want)
    GLOBAL_STATS.reset()

    jpart, _ = alacnet_tpu.decode_resumable(alacnet_tpu.DecodeCursor(str(path)), max_frames=3)
    tpart, _ = alacnet_tpu_torch.decode_resumable(
        alacnet_tpu_torch.DecodeCursor(str(path)), max_frames=3, device="cpu")
    assert tpart.pcm.dtype == jpart.pcm.dtype == np.int32
    np.testing.assert_array_equal(tpart.pcm, jpart.pcm)

    jctx = alacnet_tpu.AlacContext(io.BytesIO(data), window=3)
    tctx = alacnet_tpu_torch.AlacContext(io.BytesIO(data), window=3, device="cpu")
    j, t = jctx.read_frame(), tctx.read_frame()
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tctx.read_all(), pcm[FS:])
