"""The port's mesh (parallel/mesh.py) on the CPU: a mesh of CPU devices
runs the same decode and encode as one device, lane for lane and byte
for byte, and two cases against the JAX package's 8-device CPU mesh.

The plain ``rice_lpc`` loops over samples (about 1 ms a step) once per
shard and channel, so the corpora use 64-256-sample frames.
"""

import dataclasses
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from alacnet_tpu.codec.cookie import CodecParams as JParams  # noqa: E402
from alacnet_tpu.codec.framemeta_vec import (  # noqa: E402
    parse_frame_headers_vec as j_parse,
)
from alacnet_tpu.parallel import mesh as jmesh  # noqa: E402
from alacnet_tpu.parallel import pipeline as jpipeline  # noqa: E402

import alacnet_tpu_torch as at  # noqa: E402
from alacnet_tpu_torch import cli as tcli  # noqa: E402
from alacnet_tpu_torch.codec import encoder_device as ed  # noqa: E402
from alacnet_tpu_torch.codec.cookie import default_cookie  # noqa: E402
from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec  # noqa: E402
from alacnet_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from alacnet_tpu_torch.parallel import pipeline  # noqa: E402

from .corpus import tone  # noqa: E402

CPU = at.DecodeConfig(device="cpu")


def cpu_mesh(n: int) -> tmesh.Mesh:
    return tmesh.Mesh(["cpu"] * n)


def jparams(p):
    """The JAX package's CodecParams with the port's fields."""
    return JParams(**dataclasses.asdict(p))


def _frames(pcm, S):
    return [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]


@pytest.fixture(scope="module")
def tiny():
    """16 stereo 64-sample frames (the dry run's corpus) as payloads."""
    params, _, pcm, payloads = tmesh._tiny_corpus(16, 64)
    return params, pcm, payloads


@pytest.fixture(scope="module")
def mixed_blob():
    """A blob of 64-sample frames in four formats (16-bit stereo order 4,
    16-bit mono, 24-bit stereo with one extra-bits byte, raw 16-bit
    stereo): two planner spans, every decode kernel's path."""
    S = 64
    groups = [
        (16, 2, at.EncoderConfig(order=4), 20, 60.0),
        (16, 1, at.EncoderConfig(order=6), 4, 60.0),
        (24, 2, at.EncoderConfig(order=4, uncompressed_bytes=1), 3, 3000.0),
        (16, 2, at.EncoderConfig(force_uncompressed=True), 2, 60.0),
    ]
    payloads, params = [], []
    for seed, (bits, ch, cfg, count, noise) in enumerate(groups):
        p = default_cookie(44100, bits, ch, max_samples_per_frame=S)
        enc = at.AlacEncoder(p, cfg)
        pcm = tone(S * count - 5 * (seed == 0), ch, bits, noise=noise, seed=seed)
        payloads += [enc.encode_frame(f) for f in _frames(pcm, S)]
        params += [p] * len(_frames(pcm, S))
    sizes = np.array([len(p) for p in payloads], np.int64)
    offsets = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    blob = np.frombuffer(b"".join(payloads), np.uint8)
    return blob, offsets, sizes, params, S


def test_decode_frames_sharded_matches_jax_mesh(tiny):
    """The port's decode_frames_sharded over 8 CPU shards against the
    JAX package's on its 8-device CPU mesh: out, n, total and checksum,
    exact."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    params, pcm, payloads = tiny
    fb = pipeline.pad_frame_batch(parse_frame_headers_vec(payloads, params), 16)
    out, n, total, ck = tmesh.decode_frames_sharded(fb, cpu_mesh(8), 64)
    assert [p.shape[0] for p in out.parts] == [2] * 8

    jfb = jpipeline.pad_frame_batch(j_parse(payloads, jparams(params)), 16)
    jout, jn, jtotal, jck = jmesh.decode_frames_sharded(
        jfb, jmesh.make_mesh(jax.devices()[:8]), 64
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert out.numpy().dtype == np.asarray(jout).dtype
    assert total == int(jtotal) == pcm.shape[0]
    assert ck == int(jck)
    assert ck & 0xFFFFFFFF == int(pcm.astype(np.int64).sum()) & 0xFFFFFFFF


def test_checksum_wraps_like_an_int32_sum():
    """Accounting over shards: the int64 sums of the shards, masked,
    are the wrapping int32 sum of the whole padded output."""
    rng = np.random.default_rng(5)
    parts = [rng.integers(-(1 << 31), 1 << 31, (3, 5, 2), dtype=np.int64).astype(np.int32)
             for _ in range(3)]
    out = tmesh.Sharded(tuple(torch.from_numpy(p) for p in parts), (None,) * 3)
    n = tmesh.Sharded(tuple(torch.full((3,), 7, dtype=torch.int32) for _ in parts), (None,) * 3)
    total, ck = tmesh.local_accounting(out, n)
    with np.errstate(over="ignore"):
        want = np.concatenate(parts).sum(dtype=np.int32)
    assert total == 63
    assert tmesh.wrap_int32(ck) == int(want)


@pytest.mark.parametrize("devpack", [True, False], ids=["device_pack", "host_rows"])
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_decode_blob_mesh_equals_single_device(mixed_blob, shards, devpack):
    """decode_blob(mesh=) over 1, 3 (no bucket divides by 3) and 8 CPU
    shards equals the single-device decode: samples, dtype, n, status."""
    blob, offsets, sizes, params, S = mixed_blob
    cfg = at.DecodeConfig(device="cpu", device_pack=devpack)
    want = pipeline.decode_blob(blob, offsets, sizes, params, S, config=cfg)
    got = pipeline.decode_blob(blob, offsets, sizes, params, S, config=cfg,
                               mesh=cpu_mesh(shards))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > 0


def test_decode_blob_mesh_matches_jax_mesh(mixed_blob, monkeypatch):
    """One case against the JAX package: decode_blob(mesh=) over 8
    shards with device row assembly, on both sides."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    from alacnet_tpu import config as jcfg

    blob, offsets, sizes, params, S = mixed_blob
    monkeypatch.setattr(jcfg.DEFAULT, "device_pack", True)
    want = jpipeline.decode_blob(blob, offsets, sizes, [jparams(p) for p in params], S,
                                 mesh=jmesh.make_mesh(jax.devices()[:8]))
    got = pipeline.decode_blob(blob, offsets, sizes, params, S,
                               config=at.DecodeConfig(device="cpu"), mesh=cpu_mesh(8))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_mesh_batches_pad_to_the_shard_multiple(mixed_blob):
    """Each batch pads to its bucket and then to a multiple of the shard
    count, and every shard gets an equal lane slice (the sink sees the
    padded, planner-order Sharded arrays)."""
    blob, offsets, sizes, params, S = mixed_blob
    seen = []

    def sink(out, n, orig_b):
        seen.append(([p.shape[0] for p in out.parts], [p.shape[0] for p in n.parts],
                     orig_b, int(n.numpy().sum()), int(n.numpy()[orig_b:].sum())))

    _, _, status = pipeline.decode_blob(blob, offsets, sizes, params, S, sink=sink,
                                        config=CPU, mesh=cpu_mesh(3))
    assert len(status) == len(sizes)
    # Spans of 26 and 3 frames: buckets 64 and 8, then 66 and 9 lanes.
    assert sorted((o, orig) for o, _, orig, _, _ in seen) == [([3] * 3, 3), ([22] * 3, 26)]
    assert all(o == m for o, m, _, _, _ in seen)
    assert sum(t for *_, t, _ in seen) == 29 * S - 5
    assert all(pad == 0 for *_, pad in seen)  # pad lanes decode nothing


def test_sharded_fetch_trims_lanes():
    parts = tuple(torch.arange(6 * i, 6 * i + 6, dtype=torch.int16).reshape(3, 2)
                  for i in range(3))
    sh = tmesh.Sharded(parts, (None,) * 3)
    assert sh.shape == (9, 2)
    np.testing.assert_array_equal(sh.numpy(), np.arange(18).reshape(9, 2))
    np.testing.assert_array_equal(sh.numpy(4), np.arange(8).reshape(4, 2))
    empty = sh.numpy(0)
    assert empty.shape == (0, 2) and empty.dtype == np.int16
    cm = tmesh.Sharded(tuple(p.reshape(2, 3, 1) for p in parts), (None,) * 3, axis=1)
    assert cm.numpy().shape == (2, 9, 1)


@pytest.fixture(scope="module")
def ragged_frames():
    """17 frames of 256 samples: a silent one, a mono one and a partial
    one among stereo frames (tests/test_sharding.py's case)."""
    S = 256
    frames = [tone(S, 2, 16, seed=i) for i in range(17)]
    frames[3] = np.zeros((S, 2), np.int32)
    frames[5] = tone(S, 1, 16, seed=99)
    frames[11] = tone(S // 2 + 3, 2, 16, seed=7)
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=4)
    host = [at.AlacEncoder(params, cfg).encode_frame(f) for f in frames]
    single = ed.encode_frames_device(frames, params, cfg, device="cpu")
    return frames, params, cfg, host, single


@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "classic"])
@pytest.mark.parametrize("shards", [3, 8])
def test_encode_frames_device_mesh_byte_identical(ragged_frames, shards, pairs, monkeypatch):
    """encode_frames_device(mesh=) on the ragged, mixed case: the pad
    frames' payloads dropped, each shard folding only its own channels;
    byte-identical to the single device and to the host encoder, with
    the pair planes and with the classic ones."""
    frames, params, cfg, host, single = ragged_frames
    assert single == host
    seen = []
    real_pack = ed._pack

    def pack(prep, fetch, timings):
        seen.append((prep["F"], prep["real_frames"], prep["pairs"]))
        return real_pack(prep, fetch, timings)

    monkeypatch.setattr(ed, "_pack", pack)
    got = ed.encode_frames_device(frames, params, cfg, mesh=cpu_mesh(shards), pairs=pairs)
    assert got == host
    assert seen == [(-(-17 // shards) * shards, 17, pairs)]


def test_encode_chunks_grow_with_the_shard_count(monkeypatch):
    """The chunk is ``chunk_frames`` (default CHUNK_FRAMES) times the
    shard count; a ragged last chunk pads to the shard multiple."""
    S = 64
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=2)
    frames = _frames(tone(S * 11, 2, 16), S)
    monkeypatch.setattr(ed, "CHUNK_FRAMES", 2)
    seen = []
    real_pack = ed._pack

    def pack(prep, fetch, timings):
        seen.append((prep["F"], prep["real_frames"]))
        return real_pack(prep, fetch, timings)

    monkeypatch.setattr(ed, "_pack", pack)
    got = ed.encode_frames_device(frames, params, cfg, mesh=cpu_mesh(3))
    assert seen == [(6, 6), (6, 5)]
    assert got == [at.AlacEncoder(params, cfg).encode_frame(f) for f in frames]


def _m4a(pcm, bits, S=256, rate=44100):
    buf = io.BytesIO()
    at.encode_m4a(buf, pcm, rate, bits, at.EncoderConfig(order=4), max_samples_per_frame=S)
    return buf.getvalue()


@pytest.fixture(scope="module")
def m4a_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_files")
    paths = []
    for name, pcm, bits in (
        ("a.m4a", tone(256 * 5 + 9, 2, 16), 16),
        ("b.m4a", tone(256 * 3, 1, 16, seed=3), 16),
        ("c.m4a", tone(256 * 2 + 100, 2, 24, noise=2000.0, seed=4), 24),
    ):
        (d / name).write_bytes(_m4a(pcm, bits))
        paths.append(str(d / name))
    return paths


def test_decode_files_mesh_passthrough(m4a_files):
    want = at.decode_files(m4a_files, device="cpu")
    got = at.decode_files(m4a_files, mesh=cpu_mesh(3))
    for g, w in zip(got, want):
        assert g.pcm.dtype == w.pcm.dtype
        np.testing.assert_array_equal(g.pcm, w.pcm)
        assert (g.sample_rate, g.bits_per_sample, g.channels, g.path) == (
            w.sample_rate, w.bits_per_sample, w.channels, w.path)


def test_encode_m4a_and_files_mesh_byte_identical(tmp_path):
    pcm = tone(256 * 4 + 31, 2, 16, seed=11)
    host = io.BytesIO()
    at.encode_m4a(host, pcm, 44100, 16, max_samples_per_frame=256)
    meshed = io.BytesIO()
    at.encode_m4a(meshed, pcm, 44100, 16, max_samples_per_frame=256, mesh=cpu_mesh(3))
    assert meshed.getvalue() == host.getvalue()
    pcms = [pcm, tone(300, 1, 16, seed=2)]
    outs_host = [io.BytesIO(), io.BytesIO()]
    outs_mesh = [io.BytesIO(), io.BytesIO()]
    at.encode_files(pcms, outs_host, 44100, 16, max_samples_per_frame=256, device=None)
    at.encode_files(pcms, outs_mesh, 44100, 16, max_samples_per_frame=256, mesh=cpu_mesh(2))
    assert [o.getvalue() for o in outs_mesh] == [o.getvalue() for o in outs_host]


def test_cli_mesh_on_the_cpu(m4a_files, tmp_path, monkeypatch, capsys):
    """``--mesh`` with ``--device cpu``: batch-decode, batch-encode and
    encode build their mesh on --device's type and write what the
    single-device run writes."""
    from alacnet_tpu_torch.codec import encoder as tenc

    built = []

    def make_mesh(devices=None):
        built.append(devices)
        return cpu_mesh(3)

    monkeypatch.setattr(tmesh, "make_mesh", make_mesh)
    # 256-sample frames keep the plain encode loops short.
    for name in ("encode_files", "encode_m4a"):
        monkeypatch.setattr(tenc, name, functools.partial(getattr(tenc, name),
                                                          max_samples_per_frame=256))
    for mesh in (False, True):
        out = tmp_path / f"dec{int(mesh)}"
        args = ["batch-decode", *m4a_files, "--out-dir", str(out), "--device", "cpu"]
        assert tcli.main(args + ["--mesh"] * mesh) == 0
    wavs = sorted(p.name for p in (tmp_path / "dec0").iterdir())
    for name in wavs:
        assert (tmp_path / "dec1" / name).read_bytes() == (tmp_path / "dec0" / name).read_bytes()
    wav_paths = [str(tmp_path / "dec0" / n) for n in wavs]
    for mesh in (False, True):
        args = ["batch-encode", *wav_paths, "--out-dir", str(tmp_path / f"enc{int(mesh)}"),
                "--device", "cpu"]
        assert tcli.main(args + ["--mesh"] * mesh) == 0
        args = ["encode", wav_paths[0], str(tmp_path / f"one{int(mesh)}.m4a"), "--device", "cpu"]
        assert tcli.main(args + ["--mesh"] * mesh) == 0
    for name in sorted(p.name for p in (tmp_path / "enc0").iterdir()):
        assert (tmp_path / "enc1" / name).read_bytes() == (tmp_path / "enc0" / name).read_bytes()
    assert (tmp_path / "one1.m4a").read_bytes() == (tmp_path / "one0.m4a").read_bytes()
    assert built == [[torch.device("cpu")]] * 3
    capsys.readouterr()


def test_port_dryrun_multichip_on_eight_cpu_shards():
    rec = tmesh.dryrun_multichip(8, ["cpu"] * 8)
    assert rec["shards"] == 8 and rec["samples"] == 16 * 64 and rec["encoded_frames"] == 17


def test_make_mesh_never_picks_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: make_mesh() would use it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.Mesh(["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        at.decode_streams([], mesh=tmesh.make_mesh())


def test_mesh_rejects_bad_device_lists():
    with pytest.raises(ValueError):
        tmesh.Mesh([])
    with pytest.raises(ValueError):
        tmesh.Mesh(["cpu", "meta"])
    mesh = cpu_mesh(3)
    assert mesh.size == 3 and mesh.streams == (None,) * 3
    assert mesh.axis_names == (tmesh.FRAME_AXIS,)
    with pytest.raises(ValueError, match="equal shards"):
        mesh.lanes(8)
