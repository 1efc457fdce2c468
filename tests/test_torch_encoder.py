"""The port's batch encoder (codec/encoder_device.py) against the JAX
package's device encoder and the host encoder: byte equality.

On the CPU the encode stages run their plain torch versions (the
kernels' references, tests/test_torch_encode_ops.py); everything around
them — prep, the pipeline with its pack worker, the pair packer and its
fat-pair fallback, the muxer — is the code the card runs.
"""

import hashlib
import io
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import alacnet_tpu  # noqa: E402
from alacnet_tpu.codec.cookie import default_cookie as jax_cookie  # noqa: E402
from alacnet_tpu.codec.encoder import AlacEncoder as JaxAlacEncoder  # noqa: E402
from alacnet_tpu.codec.encoder import EncoderConfig as JaxEncoderConfig  # noqa: E402
from alacnet_tpu.codec.encoder_tpu import encode_frames_tpu  # noqa: E402

import alacnet_tpu_torch as at  # noqa: E402
from alacnet_tpu_torch import native  # noqa: E402
from alacnet_tpu_torch.codec import encoder_device as ed  # noqa: E402
from alacnet_tpu_torch.codec.cookie import default_cookie  # noqa: E402

from .corpus import tone  # noqa: E402
from .test_encoder_tpu import CASES, S, _signal  # noqa: E402

SMOKE = pathlib.Path(__file__).parent / "fixtures" / "torch_smoke"


def _jax_cfg(cfg):
    return JaxEncoderConfig(**vars(cfg))


def _port_cfg(cfg):
    return at.EncoderConfig(**vars(cfg))


@pytest.mark.parametrize("name,bits,ch,cfg,kind", CASES, ids=[c[0] for c in CASES])
def test_device_encoder_matches_jax_and_host(name, bits, ch, cfg, kind, rng):
    pcm = _signal(kind, bits, ch, rng)
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    jparams = jax_cookie(44100, bits, ch, max_samples_per_frame=S)
    params = default_cookie(44100, bits, ch, max_samples_per_frame=S)
    jenc = JaxAlacEncoder(jparams, cfg)
    host = [jenc.encode_frame(f) for f in frames]
    timings = {}
    got = ed.encode_frames_device(
        frames, params, _port_cfg(cfg), timings=timings, device="cpu"
    )
    assert got == encode_frames_tpu(frames, jparams, cfg)
    assert got == host
    port_enc = at.AlacEncoder(params, _port_cfg(cfg))
    assert [port_enc.encode_frame(f) for f in frames] == host
    assert {"prep_s", "emit_wait_s", "pack_s"} <= set(timings)


def _mixed_frames():
    return [
        tone(S, 2, 16, seed=1),
        tone(S // 2 + 9, 2, 16, seed=2),  # partial (hassize)
        tone(S, 1, 16, seed=3),  # mono: its channel-B lane has n = 0
        np.zeros((S, 2), np.int32),  # silence: zero runs
        tone(S, 2, 16, seed=4),
        tone(17, 1, 16, seed=5),  # short mono
        tone(S, 2, 16, seed=6),
    ]


def test_mixed_batch_through_the_pipeline(monkeypatch):
    """Mono, stereo, partial and silent frames in chunks of two: four
    chunks pass the bounded pipeline and its pack worker, in order."""
    frames = _mixed_frames()
    cfg = at.EncoderConfig(order=4)
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    dispatched = []
    real = ed._dispatch

    def counting(prep, *a, **k):
        dispatched.append(prep["F"])
        return real(prep, *a, **k)

    monkeypatch.setattr(ed, "_dispatch", counting)
    got = ed.encode_frames_device(frames, params, cfg, chunk_frames=2, device="cpu")
    assert dispatched == [2, 2, 2, 1]
    host = at.AlacEncoder(params, cfg)
    assert got == [host.encode_frame(f) for f in frames]
    jparams = jax_cookie(44100, 16, 2, max_samples_per_frame=S)
    assert got == encode_frames_tpu(frames, jparams, _jax_cfg(cfg), chunk_frames=2)


@pytest.mark.skipif(not native.available(), reason="no native tier")
def test_fat_pair_falls_back_to_classic():
    """A set fat flag re-dispatches the classic per-sample planes and
    still gives the host encoder's bytes."""
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    pcm = tone(S * 2, 2, 16, noise=60.0)
    frames = [pcm[:S], pcm[S:]]
    enc = at.AlacEncoder(params, cfg)
    want = [enc.encode_frame(f) for f in frames]

    prep = ed._prep(frames, params, cfg, enc)
    fetch = ed._dispatch(prep, params, cfg, torch.device("cpu"), pairs=True)
    assert prep["pairs"] is True

    def forced():
        planes = list(fetch())
        planes[6] = np.ones_like(planes[6])  # the fat flag
        return tuple(planes)

    got = ed._pack_host_pairs(prep, forced, None)
    assert got == want
    assert prep["pairs"] is False  # the fallback resets the routing flag


def test_python_packer_matches_host():
    """The pure-Python packer (taken where the native tier cannot be
    built) writes the host encoder's bytes from the classic planes,
    extra-bits plane included."""
    params = default_cookie(44100, 24, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=4, uncompressed_bytes=1)
    frames = [tone(S, 2, 24, noise=3000.0, seed=31), tone(S // 3, 2, 24, seed=32)]
    enc = at.AlacEncoder(params, cfg)
    prep = ed._prep(frames, params, cfg, enc)
    fetch = ed._dispatch(prep, params, cfg, torch.device("cpu"), pairs=False)
    c0, c1, c2, ws, _, _ = ed._fetch_lane_major(fetch)
    assert ed._pack_py(prep, c0, c1, c2, ws) == [enc.encode_frame(f) for f in frames]


def test_desync_flag_raises():
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    frames = [tone(S, 2, 16)]
    prep = ed._prep(frames, params, cfg, at.AlacEncoder(params, cfg))
    fetch = ed._dispatch(prep, params, cfg, torch.device("cpu"))

    def desynced():
        planes = list(fetch())
        planes[5] = np.ones_like(planes[5])  # the bad flag
        return tuple(planes)

    with pytest.raises(RuntimeError, match="desync"):
        ed._pack(prep, desynced, None)


def test_wide_shift_past_16_matches_host(rng):
    """24-bit stereo with interlacing_shift > 16 and a large leftweight:
    the port takes the product in int64, as the host encoder does.  (The
    JAX package's split int32 emulation drops the low partial's carry
    for shifts past 16, so its device bytes differ from its host bytes
    here.)"""
    params = default_cookie(44100, 24, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=4, interlacing_shift=20, interlacing_leftweight=200)
    pcm = rng.integers(-(1 << 23), 1 << 23, (2 * S, 2)).astype(np.int32)
    frames = [pcm[:S], pcm[S:]]
    host = at.AlacEncoder(params, cfg)
    got = ed.encode_frames_device(frames, params, cfg, device="cpu")
    assert got == [host.encode_frame(f) for f in frames]


def _library():
    """Three formats, two files each: 16-bit stereo, 24-bit stereo,
    16-bit mono; lengths not a multiple of the frame."""
    return [
        (tone(3 * S + 40, 2, 16, seed=11), 44100, 16),
        (tone(S + 3, 1, 16, seed=12), 22050, 16),
        (tone(2 * S + 7, 2, 24, noise=3000.0, seed=13), 48000, 24),
        (tone(2 * S, 2, 16, seed=14), 44100, 16),
        (tone(S - 5, 2, 24, noise=3000.0, seed=15), 48000, 24),
        (tone(2 * S + 1, 1, 16, seed=16), 22050, 16),
    ]


def test_pooled_encode_files_matches_jax():
    lib = _library()
    pcms, rates, bits = zip(*lib)
    cfg = at.EncoderConfig(order=5)
    outs = [io.BytesIO() for _ in lib]
    jouts = [io.BytesIO() for _ in lib]
    at.encode_files(pcms, outs, rates, bits, config=cfg,
                    max_samples_per_frame=S, device="cpu")
    alacnet_tpu.encode_files(pcms, jouts, rates, bits, config=_jax_cfg(cfg),
                             max_samples_per_frame=S, device=True)
    for i, (o, j) in enumerate(zip(outs, jouts)):
        assert o.getvalue() == j.getvalue(), f"file {i}"
    # the host path of the same entry point writes the same files
    host = [io.BytesIO() for _ in lib]
    at.encode_files(pcms, host, rates, bits, config=cfg,
                    max_samples_per_frame=S, device=None)
    assert [h.getvalue() for h in host] == [o.getvalue() for o in outs]


def test_encode_then_port_decode_round_trip():
    lib = _library()
    pcms, rates, bits = zip(*lib)
    outs = [io.BytesIO() for _ in lib]
    at.encode_files(pcms, outs, rates, bits, max_samples_per_frame=S, device="cpu")
    got = at.decode_streams([io.BytesIO(o.getvalue()) for o in outs], device="cpu")
    for (pcm, rate, b), r in zip(lib, got):
        assert r.sample_rate == rate and r.bits_per_sample == b
        np.testing.assert_array_equal(r.pcm, pcm)


def test_encode_m4a_device_matches_host():
    pcm = tone(2 * S + 9, 2, 16, seed=21)
    a, b = io.BytesIO(), io.BytesIO()
    at.encode_m4a(a, pcm, 44100, 16, max_samples_per_frame=S, device="cpu")
    at.encode_m4a(b, pcm, 44100, 16, max_samples_per_frame=S)
    assert a.getvalue() == b.getvalue()


def test_mono16_matches_encode_expected():
    """The smoke corpus's mono file, re-encoded at the full frame size
    (4096 samples), against the JAX encoder's bytes."""
    want = json.loads((SMOKE / "encode_expected.json").read_text())["mono16.m4a|default"]
    r = at.decode_file(SMOKE / "mono16.m4a", device="cpu")
    out = io.BytesIO()
    at.encode_files([r.pcm], [out], r.sample_rate, r.bits_per_sample, device="cpu")
    data = out.getvalue()
    assert len(data) == want["bytes"]
    assert hashlib.sha256(data).hexdigest() == want["sha256"]


def test_device_encoder_rejects_what_it_cannot_run():
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    frames = [tone(S, 2, 16)]
    with pytest.raises(ValueError, match="compressed"):
        ed.encode_frames_device(frames, params, at.EncoderConfig(force_uncompressed=True),
                                device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        ed.encode_frames_device(frames, params, device="cpu", kernel="cuda")
    with pytest.raises(ValueError, match="kernel"):
        ed.encode_frames_device(frames, params, device="cpu", kernel="fused")
    assert ed.encode_frames_device([], params, device="cpu") == []
