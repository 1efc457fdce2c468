"""The port's decode path as a whole against the JAX package.

``decode_frames_packed`` on the same packed metadata matrix and words
as the JAX ``decode_frames_packed(use_fused=False)``; ``decode_files``
(on the CPU, where every kernel wrapper runs its plain version) against
``alacnet_tpu.decode_files`` on the committed fixtures, pooled as one
mixed 16/24-bit, mono/stereo set; and the smoke corpus against the
sha256 of the JAX package's PCM in ``expected.json``.  Exact equality.
"""

import dataclasses
import hashlib
import io
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import alacnet_tpu  # noqa: E402
import alacnet_tpu_torch  # noqa: E402
from alacnet_tpu.codec import framemeta_vec as j_fmv  # noqa: E402
from alacnet_tpu.ops import frame_decode as jfd  # noqa: E402
from alacnet_tpu.parallel import pipeline as j_pipe  # noqa: E402
from alacnet_tpu_torch.ops import frame_decode as tfd  # noqa: E402
from alacnet_tpu_torch.parallel import pipeline as t_pipe  # noqa: E402

from .test_torch_host import pool  # noqa: E402

FIX = pathlib.Path(__file__).parent / "fixtures"
FIXTURES = sorted(FIX.glob("*.m4a"))
SMOKE = FIX / "torch_smoke"
CPU = alacnet_tpu_torch.DecodeConfig(device="cpu")


@pytest.fixture(scope="module")
def jax_fixture_decode():
    return alacnet_tpu.decode_files(FIXTURES)


def _first_frames(paths, k):
    """Pooled (blob, offsets, sizes, jax params) of each file's first k frames."""
    blob, offs, szs, jp, _ = pool(paths)
    keep, lo = [], 0
    for p in paths:
        nf = len(alacnet_tpu.parse(io.BytesIO(p.read_bytes())).tables.frame_byte_sizes)
        keep.extend(range(lo, lo + min(k, nf)))
        lo += nf
    keep = np.asarray(keep)
    return blob, offs[keep], szs[keep], [jp[i] for i in keep]


@pytest.mark.parametrize(
    "paths,frames,emit16",
    [
        (FIXTURES, 99, False),
        ([p for p in FIXTURES if "24" not in p.name], 99, True),
        (sorted(SMOKE.glob("*.m4a")), 2, False),
    ],
    ids=["fixtures", "fixtures16-emit16", "smoke-first2"],
)
def test_decode_frames_packed_matches_jax(paths, frames, emit16):
    blob, offs, szs, jp = _first_frames(paths, frames)
    fb = j_pipe.pad_frame_batch(j_fmv.parse_frame_headers_blob(blob, offs, szs, jp))
    S = max(p.max_samples_per_frame for p in jp)
    packed = jfd.FrameMetaArrays.pack_host(fb)
    j_out, j_n = jfd.decode_frames_packed(
        jnp.asarray(fb.words), jnp.asarray(packed), S, use_fused=False,
        emit16=emit16,
    )
    t_out, t_n = tfd.decode_frames_packed(
        torch.from_numpy(fb.words.view(np.int32).copy()), packed, S,
        emit16=emit16,
    )
    assert str(t_out.dtype) == "torch." + str(np.asarray(j_out).dtype)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))


def test_from_packed_unpacks_the_same_columns():
    blob, offs, szs, jp = _first_frames(FIXTURES, 99)
    fb = j_fmv.parse_frame_headers_blob(blob, offs, szs, jp)
    packed = jfd.FrameMetaArrays.pack_host(fb)
    jm = jfd.FrameMetaArrays.unpack(jnp.asarray(packed))
    tm = tfd.FrameMetaArrays.from_packed(packed, "cpu")
    for name in jfd.FrameMetaArrays._fields:
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)), err_msg=name
        )


def _assert_same_audio(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pcm.dtype == w.pcm.dtype
        np.testing.assert_array_equal(g.pcm, w.pcm)
        np.testing.assert_array_equal(g.bad_frames, w.bad_frames)
        assert (g.sample_rate, g.bits_per_sample, g.channels) == (
            w.sample_rate, w.bits_per_sample, w.channels)


@pytest.mark.parametrize(
    "overrides",
    [{}, {"device_pack": False}, {"native": False}, {"emit16": False},
     {"batch_limit": 2}],
    ids=["default", "host-rows", "numpy-parser", "int32-out", "batch2"],
)
def test_decode_files_matches_jax(overrides, jax_fixture_decode):
    got = alacnet_tpu_torch.decode_files(
        FIXTURES, config=dataclasses.replace(CPU, **overrides)
    )
    _assert_same_audio(got, jax_fixture_decode)
    assert [r.path for r in got] == [str(p) for p in FIXTURES]


def test_decode_file_matches_jax():
    p = FIXTURES[0]
    _assert_same_audio(
        [alacnet_tpu_torch.decode_file(p, device="cpu")], [alacnet_tpu.decode_file(p)]
    )


def _corrupted(path, frame):
    """The file's bytes with one frame's channel tag set to 7."""
    data = bytearray(path.read_bytes())
    info = alacnet_tpu.parse(io.BytesIO(bytes(data)))
    off = int(info.tables.frame_file_offsets()[frame])
    data[off] |= 0xE0
    return bytes(data)


def test_lenient_bad_frames_match_jax():
    data = _corrupted(FIX / "stereo16_order6.m4a", 0)
    want = alacnet_tpu.decode_streams([io.BytesIO(data)], strict=False)
    got = alacnet_tpu_torch.decode_streams([io.BytesIO(data)], strict=False, device="cpu")
    _assert_same_audio(got, want)
    assert list(got[0].bad_frames) == [0]
    with pytest.raises(alacnet_tpu_torch.UnsupportedFormatError):
        alacnet_tpu_torch.decode_streams([io.BytesIO(data)], device="cpu")


def test_decode_payloads_matches_jax():
    blob, offs, szs, jp = _first_frames(FIXTURES[:2], 99)
    payloads = [blob[o : o + s].tobytes() for o, s in zip(offs, szs)]
    S = max(p.max_samples_per_frame for p in jp)
    want = j_pipe.decode_payloads(payloads, jp, S, batch_limit=3)
    got = t_pipe.decode_payloads(payloads, jp, S, batch_limit=3, config=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sink_sees_device_batches():
    blob, offs, szs, _, tp = pool(FIXTURES)
    S = max(p.max_samples_per_frame for p in tp)
    out, n, status = t_pipe.decode_blob(blob, offs, szs, tp, S, config=CPU)
    seen = []
    e_out, e_n, e_status = t_pipe.decode_blob(
        blob, offs, szs, tp, S, config=CPU, batch_limit=3,
        sink=lambda o, nn, b: seen.append((o[:b].clone(), nn[:b].clone())),
    )
    assert e_out.shape[0] == 0 and e_n.shape[0] == 0
    np.testing.assert_array_equal(e_status, status)
    assert sum(int(nn.sum()) for _, nn in seen) == int(n.sum())
    assert all(isinstance(o, torch.Tensor) for o, _ in seen)


def test_smoke_corpus_matches_expected():
    """All smoke files pooled in one decode_streams call, as chip_smoke.py
    runs them: every file's PCM hashes to the JAX package's."""
    expected = json.loads((SMOKE / "expected.json").read_text())
    names = sorted(expected)
    got = alacnet_tpu_torch.decode_streams(
        [io.BytesIO((SMOKE / n).read_bytes()) for n in names], device="cpu"
    )
    for name, r in zip(names, got):
        e = expected[name]
        assert str(r.pcm.dtype) == e["dtype"] and list(r.pcm.shape) == e["shape"]
        assert r.pcm.shape[0] == e["samples"], name
        assert hashlib.sha256(r.pcm.tobytes()).hexdigest() == e["sha256"], name
