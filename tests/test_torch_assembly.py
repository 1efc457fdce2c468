"""Per-file assembly (``batch._file_pcm``) on the host with tiny arrays:
each file's PCM cut from the pooled (F, S, C) samples by runs of frames,
held to the per-sample boolean compress it replaced, and a
``decode_streams`` request's assembly counters.
"""

import io

import numpy as np
import pytest

pytest.importorskip("torch")

import alacnet_tpu_torch  # noqa: E402
from alacnet_tpu.codec.encoder import EncoderConfig  # noqa: E402
from alacnet_tpu_torch.batch import _file_pcm  # noqa: E402
from alacnet_tpu_torch.utils.observability import GLOBAL_STATS  # noqa: E402

from .corpus import encode_to_bytes, tone  # noqa: E402


def compress(out, n, lo, hi, nch, dtype):
    """The oracle: every frame's first n[f] samples picked by an (F, S)
    mask in one boolean compress, then cast."""
    valid = np.arange(out.shape[1])[None, :] < n[:, None]
    pcm = out[lo:hi, :, :nch].reshape(-1, nch)[valid[lo:hi].reshape(-1)]
    return pcm.astype(dtype)


def pool(n, S, C, dtype):
    """A pooled (F, S, C) array of distinct samples, with the pad past
    each frame's count set to a marker that must never show."""
    n = np.asarray(n, np.int32)
    out = np.arange(n.size * S * C, dtype=np.int64).reshape(n.size, S, C) % 30011 - 15000
    out[np.arange(S)[None, :] >= n[:, None]] = 32767
    return out.astype(dtype), n


#: (pool's n, S, C, pool dtype, files' [lo, hi) spans, nch, file dtype,
#: whether the one file is a view of the pool).
CASES = {
    "full_then_partial_view": ([8, 8, 8, 3], 8, 2, np.int32, [(0, 4)], 2, np.int32, True),
    "int16_pool_16bit_view": ([8, 8, 5], 8, 2, np.int16, [(0, 3)], 2, np.int16, True),
    "int32_pool_16bit_copy": ([8, 8, 8, 3], 8, 2, np.int32, [(0, 4)], 2, np.int16, False),
    "lenient_bad_frame_mid_file": ([8, 0, 8, 8, 2], 8, 2, np.int32, [(0, 5)], 2, np.int32, False),
    "mono_from_stereo_pool": ([8, 8, 6], 8, 2, np.int32, [(0, 3)], 1, np.int32, False),
    "two_files_one_pool": ([8, 8, 3, 8, 8, 8, 1], 8, 2, np.int32, [(0, 3), (3, 7)], 2,
                           np.int32, False),
    "frames_shorter_than_pool": ([4, 4, 4, 1], 8, 2, np.int32, [(0, 4)], 2, np.int32, False),
    "every_frame_partial": ([5, 3, 7, 1], 8, 2, np.int32, [(0, 4)], 2, np.int32, False),
    "zero_frames": ([8, 8], 8, 2, np.int32, [(1, 1)], 2, np.int32, False),
}


@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_file_pcm_matches_boolean_compress(case):
    n, S, C, pool_dtype, spans, nch, dtype, view = CASES[case]
    out, n = pool(n, S, C, pool_dtype)
    got = [_file_pcm(out, n, lo, hi, nch, np.dtype(dtype)) for lo, hi in spans]
    for pcm, (lo, hi) in zip(got, spans):
        want = compress(out, n, lo, hi, nch, dtype)
        assert pcm.dtype == want.dtype and pcm.shape == want.shape
        assert pcm.flags.c_contiguous
        np.testing.assert_array_equal(pcm, want)
        assert np.shares_memory(pcm, out) == view
    if len(got) > 1:
        assert not np.shares_memory(got[0], got[1])


FS = 64  # samples per frame


def m4a(frames, channels, bits, seed):
    pcm = tone(FS * frames + 9, channels, bits, seed=seed)
    return pcm, encode_to_bytes(pcm, 44100, bits, EncoderConfig(order=6),
                                max_samples_per_frame=FS)


def test_decode_streams_counts_views_and_runs():
    """A lone 24-bit file is its pool's view; each file of a pool of two
    is a copy of one or two runs (full frames, then the partial last)."""
    lone = m4a(5, 2, 24, seed=1)
    pair = [m4a(4, 2, 16, seed=2), m4a(6, 1, 16, seed=3)]
    config = alacnet_tpu_torch.DecodeConfig(device="cpu", batch_limit=4)

    GLOBAL_STATS.reset()
    (res,) = alacnet_tpu_torch.decode_streams([io.BytesIO(lone[1])], config=config)
    snap = GLOBAL_STATS.snapshot()
    np.testing.assert_array_equal(res.pcm, lone[0])
    assert (snap["assembled_files"], snap["assembly_views"], snap["assembly_runs"]) == (1, 1, 0)

    GLOBAL_STATS.reset()
    res = alacnet_tpu_torch.decode_streams([io.BytesIO(d) for _, d in pair], config=config)
    snap = GLOBAL_STATS.snapshot()
    for r, (pcm, _) in zip(res, pair):
        assert r.pcm.dtype == np.int16 and r.pcm.flags.c_contiguous
        np.testing.assert_array_equal(r.pcm, pcm)
    assert not np.shares_memory(res[0].pcm, res[1].pcm)
    assert (snap["assembled_files"], snap["assembly_views"], snap["assembly_runs"]) == (2, 0, 4)
    GLOBAL_STATS.reset()
