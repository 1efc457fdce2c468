"""The port's encoder packing routes against the JAX package and the host
encoder, on the CPU: bytes and planes equal, tolerance 0.

Routes: the device frame packers (``ops/encode.pack_frames_device``,
gather; ``pack_frames_device_scatter``) behind
``encode_frames_device(pack=...)``, and quad packing
(``ops/encode.merge_quad_chunks`` behind ``encode_frames_device(quads=
True)``, with the quad-fat frames repacked from their pair rows).  The
JAX side selects the same routes with its environment variables
(``ALAC_ENC_DEVICE_PACK``, ``ALAC_ENC_PACK_IMPL``, ``ALAC_ENC_QUAD``).
Inputs are made with numpy from a seed and handed to both packages.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.bench_lib import _music_pcm  # noqa: E402
from alacnet_tpu.codec.cookie import default_cookie as jax_cookie  # noqa: E402
from alacnet_tpu.codec.encoder import EncoderConfig as JaxEncoderConfig  # noqa: E402
from alacnet_tpu.codec.encoder_tpu import encode_frames_tpu  # noqa: E402
from alacnet_tpu.ops import encode as jenc  # noqa: E402

import alacnet_tpu_torch as at  # noqa: E402
from alacnet_tpu_torch import native  # noqa: E402
from alacnet_tpu_torch.codec import encoder_device as ed  # noqa: E402
from alacnet_tpu_torch.codec.bitwriter import BitWriter  # noqa: E402
from alacnet_tpu_torch.codec.cookie import default_cookie  # noqa: E402
from alacnet_tpu_torch.ops import encode as tenc  # noqa: E402
from alacnet_tpu_torch.parallel import mesh as tmesh  # noqa: E402

from .corpus import tone  # noqa: E402
from .test_encoder_tpu import CASES, S, _signal  # noqa: E402
from .test_torch_cuda import pack_planes  # noqa: E402
from .test_torch_encode_ops import _jax, _params  # noqa: E402

needs_native = pytest.mark.skipif(not native.available(), reason="no native tier")
UB0_CASES = [c for c in CASES if c[3].uncompressed_bytes == 0]


def _t(x: np.ndarray) -> torch.Tensor:
    """A numpy plane as the port holds it (uint32 as int32 bit patterns)."""
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _eq(got: torch.Tensor, want, what: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_array_equal(
        got.numpy(), want.view(np.int32) if want.dtype == np.uint32 else want, err_msg=what
    )


def _host(frames, params, cfg):
    enc = at.AlacEncoder(params, cfg)
    return [enc.encode_frame(f) for f in frames]


def _music_and_noise(rng, music: int, S_: int = S):
    """``music`` 16-bit music frames, then one full-range noise frame
    (adjacent escape symbols: its quads pass 96 bits)."""
    mus = _music_pcm(music * S_, 16, 2, rng).reshape(music, S_, 2)
    noise = rng.integers(-32768, 32767, (S_, 2)).astype(np.int32)
    return [mus[i] for i in range(music)] + [noise]


# ---------------------------------------------------------------- packers


def _bitwriter_rows(c0, c1, c2, ws, n, stereo, hbits):
    """Each frame's stream (zeroed header prefix, then its symbols) and
    end bit, written by the BitWriter."""
    F = len(n)
    w = ws.astype(np.int64)
    out = []
    for f in range(F):
        bw = BitWriter()
        rem = int(hbits[f])
        while rem > 0:
            bw.write(0, min(rem, 32))
            rem -= min(rem, 32)
        for lane in ([f, F + f] if stereo[f] else [f]):
            for i in range(int(n[f])):
                b = int(w[lane, i])
                if b <= 32:
                    bw.write(int(c2[lane, i]), b)
                elif b <= 64:
                    bw.write(int(c1[lane, i]), b - 32)
                    bw.write(int(c2[lane, i]), 32)
                else:
                    bw.write(int(c0[lane, i]), b - 64)
                    bw.write(int(c1[lane, i]), 32)
                    bw.write(int(c2[lane, i]), 32)
        out.append((bw.getvalue(), bw.bitpos))
    return out


@pytest.mark.parametrize("impl", ["gather", "scatter"])
def test_pack_frames_device_matches_jax_and_bitwriter(impl):
    rng = np.random.default_rng(11)
    (c0, c1, c2, ws), n, stereo, hbits = pack_planes(rng)
    want_rows = _bitwriter_rows(c0, c1, c2, ws, n, stereo, hbits)
    stride_words = max(bits for _, bits in want_rows) // 32 + 2
    jfn = jenc.pack_frames_device if impl == "gather" else jenc.pack_frames_device_scatter
    tfn = tenc.pack_frames_device if impl == "gather" else tenc.pack_frames_device_scatter
    j_rows, j_end = jfn(*(jnp.asarray(x) for x in (c0, c1, c2, ws, n, stereo, hbits)),
                        stride_words=stride_words)
    rows, end = tfn(_t(c0), _t(c1), _t(c2), _t(ws), _t(n), _t(stereo), _t(hbits),
                    stride_words=stride_words)
    assert rows.dtype == torch.uint8 and end.dtype == torch.int32
    assert rows.shape == (len(n), stride_words * 4)
    _eq(rows, j_rows, "rows")
    _eq(end, j_end, "end_bits")
    for f, (ref, bits) in enumerate(want_rows):
        assert int(end[f]) == bits, f"frame {f} end_bits"
        assert rows[f, : len(ref)].numpy().tobytes() == ref, f"frame {f} bytes"


def test_scatter_drops_words_past_the_stride():
    """A row too narrow for its frame keeps the words that fit, as JAX's
    ``mode="drop"`` does, and never writes past the row."""
    rng = np.random.default_rng(12)
    (c0, c1, c2, ws), n, stereo, hbits = pack_planes(rng)
    args = (c0, c1, c2, ws, n, stereo, hbits)
    j_rows, j_end = jenc.pack_frames_device_scatter(*(jnp.asarray(x) for x in args),
                                                   stride_words=8)
    rows, end = tenc.pack_frames_device_scatter(*(_t(x) for x in args), stride_words=8)
    _eq(rows, j_rows)
    _eq(end, j_end)


# ----------------------------------------------------------------- quads


def test_merge_quad_chunks_matches_jax():
    """Random pair planes (widths 0..48, odd pair count), with a poisoned
    (-1) pair on lane 1: the lane is quad-fat and no negative width
    reaches the shifts."""
    rng = np.random.default_rng(13)
    B, NP = 6, 15
    pws = rng.integers(0, 49, (B, NP)).astype(np.int8)
    pws[1, 3] = -1
    raw = rng.integers(0, 1 << 32, (3, B, NP), dtype=np.uint64)
    w = np.clip(pws.astype(np.int64), 0, 96)
    val = [(int(raw[0, b, j]) << 64 | int(raw[1, b, j]) << 32 | int(raw[2, b, j]))
           & ((1 << int(w[b, j])) - 1) for b in range(B) for j in range(NP)]
    ph, pm, pl = (np.array([(v >> s) & 0xFFFFFFFF for v in val], np.uint32).reshape(B, NP)
                  for s in (64, 32, 0))
    want = jenc.merge_quad_chunks(*(jnp.asarray(x) for x in (ph, pm, pl, pws)))
    got = tenc.merge_quad_chunks(_t(ph), _t(pm), _t(pl), _t(pws))
    for name, g, w_ in zip(("qh", "qm", "ql", "qws", "qfat"), got, want):
        _eq(g, w_, name)
    assert bool(got[4][1]) and got[3].shape == (B, (NP + 1) // 2)


def test_merge_quad_chunks_poisons_bad_pairs():
    """The JAX package's own poisoned-pair case: only the poisoned lane
    is quad-fat, and clean lanes fold two 20-bit pairs."""
    rng = np.random.default_rng(14)
    B, NP = 4, 8
    ph = np.zeros((B, NP), np.uint32)
    pm = np.zeros((B, NP), np.uint32)
    pl = rng.integers(0, 2**20, (B, NP)).astype(np.uint32)
    pws = np.full((B, NP), 20, np.int8)
    pws[1, 3] = -1
    want = jenc.merge_quad_chunks(ph, pm, pl, pws)
    got = tenc.merge_quad_chunks(_t(ph), _t(pm), _t(pl), _t(pws))
    for g, w_ in zip(got, want):
        _eq(g, w_)
    assert bool(got[4][1]) and not got[4][[0, 2, 3]].any()
    assert (got[3][0] == 40).all()


@pytest.mark.parametrize("bits,wide", [(16, False), (24, True)])
def test_encode_stages_pcm_quads_match_jax(bits, wide):
    """All twelve planes of ``encode_stages_pcm(pairs=True, quads=True)``:
    music-like lanes, a full-range noise frame (quad-fat), silence,
    mono and partial frames."""
    rng = np.random.default_rng(bits)
    F, S_ = 6, 80
    lim = 1 << (bits - 1)
    t = np.arange(S_)[:, None]
    pcm = ((lim // 8) * np.sin(t * 0.05 + np.arange(F)[:, None, None])
           + rng.normal(0, 30, (F, S_, 2))).astype(np.int32)
    pcm[1] = rng.integers(-lim, lim, (S_, 2))
    pcm[2] = 0
    stereo = np.array([1, 1, 1, 0, 1, 0], bool)
    pcm[~stereo, :, 1] = 0
    ns_f = np.array([S_, S_, S_, S_, 33, 1], np.int32)
    ns = np.concatenate([ns_f, np.where(stereo, ns_f, 0)]).astype(np.int32)
    lp, rp = _params(2 * F, 6, rng)
    rss = (bits + np.concatenate([stereo, stereo])).astype(np.int32)
    lp, rp = lp._replace(rss=rss), rp._replace(rss=rss)
    kw = dict(max_order=6, lw=2, sh=1, wide=wide, pairs=True, quads=True)
    want = jenc.encode_stages_pcm(jnp.asarray(pcm), jnp.asarray(stereo), jnp.asarray(ns),
                                  _jax(lp), _jax(rp), S_, **kw)
    tlp, trp = tenc.params_from_numpy(lp, rp, "cpu")
    got = tenc.encode_stages_pcm(_t(pcm), _t(stereo), _t(ns), tlp, trp, S_, **kw)
    names = ("ph", "pm", "pl", "pws", "bits", "bad", "fat", "qh", "qm", "ql", "qws", "qfat")
    assert len(got) == len(want) == len(names)
    for name, g, w_ in zip(names, got, want):
        _eq(g, w_, name)
    assert got[-1].any() and not got[-1].all()


def test_quads_require_pairs():
    with pytest.raises(ValueError, match="quads requires pairs"):
        tenc.encode_stages(torch.zeros((2, 4), dtype=torch.int32),
                           torch.full((2,), 4, dtype=torch.int32), None, None, 4,
                           quads=True)


# ----------------------------------------------------- the encoder's routes


@pytest.mark.parametrize("impl", ["gather", "scatter"])
@pytest.mark.parametrize("name,bits,ch,cfg,kind", UB0_CASES, ids=[c[0] for c in UB0_CASES])
def test_device_pack_matches_jax_and_host(name, bits, ch, cfg, kind, impl, monkeypatch):
    pcm = _signal(kind, bits, ch, np.random.default_rng(bits * ch + cfg.order))
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    params = default_cookie(44100, bits, ch, max_samples_per_frame=S)
    pcfg = at.EncoderConfig(**vars(cfg))
    timings = {}
    got = ed.encode_frames_device(frames, params, pcfg, timings=timings, device="cpu",
                                  pack=impl)
    assert timings["device_pack_chunks"] == 1
    assert got == _host(frames, params, pcfg)
    monkeypatch.setenv("ALAC_ENC_DEVICE_PACK", "1")
    monkeypatch.setenv("ALAC_ENC_PACK_IMPL", impl)
    assert got == encode_frames_tpu(frames, jax_cookie(44100, bits, ch, S), cfg)


def test_device_pack_with_extra_bits_takes_the_host_packer(monkeypatch):
    """A ub = 1 batch under ``pack="scatter"`` packs on the host (the
    classic packer, as the JAX package does), bytes unchanged."""
    cfg = JaxEncoderConfig(order=4, uncompressed_bytes=1)
    pcm = _signal("music", 24, 2, np.random.default_rng(24))
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    params = default_cookie(44100, 24, 2, max_samples_per_frame=S)
    pcfg = at.EncoderConfig(**vars(cfg))
    packers = []
    monkeypatch.setattr(ed, "_pack_host", lambda *a, real=ed._pack_host: (
        packers.append("host") or real(*a)))
    timings = {}
    got = ed.encode_frames_device(frames, params, pcfg, timings=timings, device="cpu",
                                  pack="scatter")
    assert packers == ["host"] and "device_pack_chunks" not in timings
    assert got == _host(frames, params, pcfg)
    monkeypatch.setenv("ALAC_ENC_DEVICE_PACK", "1")
    assert got == encode_frames_tpu(frames, jax_cookie(44100, 24, 2, S), cfg)


def test_device_pack_copies_back_only_rows():
    """The device pack's D2H: the flags, then the rows and their end
    bits; no chunk plane."""
    frames = [tone(S, 2, 16, seed=s) for s in range(3)]
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=4)
    prep = ed._prep(frames, params, cfg, at.AlacEncoder(params, cfg))
    fetch = ed._dispatch(prep, params, cfg, torch.device("cpu"), pack="scatter")
    assert prep["device_pack"] == "scatter" and not prep["pairs"]
    assert ed._pack(prep, fetch, None) == _host(frames, params, cfg)
    B, stride_words = 2 * len(frames), 256
    flags = B * 4 + B  # bits (int32), bad (bool)
    assert fetch.d2h_bytes == flags + len(frames) * (stride_words * 4 + 4)


@needs_native
def test_quads_fire_on_16bit_music(monkeypatch):
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    pcm = tone(S * 3 + 57, 2, 16, noise=60.0)
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    timings = {}
    got = ed.encode_frames_device(frames, params, cfg, timings=timings, device="cpu",
                                  quads=True, chunk_frames=2)
    assert timings["quad_chunks"] == 2 and timings["repacked_frames"] == 0
    assert got == ed.encode_frames_device(frames, params, cfg, device="cpu")
    assert got == _host(frames, params, cfg)
    monkeypatch.setenv("ALAC_ENC_QUAD", "1")
    assert got == encode_frames_tpu(frames, jax_cookie(44100, 16, 2, S),
                                    JaxEncoderConfig(order=6))


@needs_native
def test_quads_copy_back_one_plane_set():
    """Quads: the flags cross at dispatch, then the quad planes only."""
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    frames = [tone(S, 2, 16, noise=60.0, seed=s) for s in range(2)]
    prep = ed._prep(frames, params, cfg, at.AlacEncoder(params, cfg))
    fetch = ed._dispatch(prep, params, cfg, torch.device("cpu"), quads=True)
    assert prep["quads"] and sorted(fetch._waits) == [4, 5, 6, 11]
    assert ed._pack(prep, fetch, None) == _host(frames, params, cfg)
    assert sorted(fetch._host) == [4, 5, 6, 7, 8, 9, 10, 11]
    B, NQ = 4, S // 4
    assert fetch.d2h_bytes == B * (4 + 1 + 1 + 1) + B * NQ * (3 * 4 + 1)


@needs_native
def test_forced_qfat_falls_back_to_pairs():
    """Every frame quad-fat: the pair planes pack (not the classic ones),
    and the routing stays on pairs."""
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    pcm = tone(S * 3 + 57, 2, 16, noise=60.0)
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    prep = ed._prep(frames, params, cfg, at.AlacEncoder(params, cfg))
    fetch = ed._dispatch(prep, params, cfg, torch.device("cpu"), quads=True)
    assert prep["quads"] is True
    qfat = fetch.get(11)[0]
    assert not qfat.any(), "quads unexpectedly fat"
    qfat[:] = True
    timings = {}
    assert ed._pack_host_pairs(prep, fetch, timings) == _host(frames, params, cfg)
    assert prep["pairs"] is True and timings["quad_chunks"] == 0
    assert 0 in fetch._host and 7 not in fetch._host


@needs_native
def test_minority_quad_fat_frame_is_repacked(monkeypatch):
    """Seven music frames and one full-range noise frame: the noise
    frame's quads pass 96 bits, so it alone is repacked from its pair
    rows while the rest ride the quad planes."""
    frames = _music_and_noise(np.random.default_rng(15), 7)
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    prep = ed._prep(frames, params, cfg, at.AlacEncoder(params, cfg))
    fetch = ed._dispatch(prep, params, cfg, torch.device("cpu"), quads=True)
    fat, qfat = fetch.get(6, 11)
    assert not fat.any(), "a fat pair would mask the case"
    assert list(np.flatnonzero(qfat[:8] | qfat[8:])) == [7]
    timings = {}
    got = ed.encode_frames_device(frames, params, cfg, timings=timings, device="cpu",
                                  quads=True)
    assert timings["quad_chunks"] == 1 and timings["repacked_frames"] == 1
    assert got == _host(frames, params, cfg)
    monkeypatch.setenv("ALAC_ENC_QUAD", "1")
    assert got == encode_frames_tpu(frames, jax_cookie(44100, 16, 2, S),
                                    JaxEncoderConfig(order=6))


@needs_native
def test_quad_fat_frame_in_a_lockstep_group_with_a_wide_column():
    """Sixteen equal-shape frames: two lockstep 8-groups for the AVX-512
    pair packer.  Group 0 holds a quad-fat noise frame (-1 quad widths)
    beside a loud frame whose quads pass 64 bits in the same columns:
    the packer's wide branch pushes the fat lane's unmasked value
    (ADVICE.md, ``_native/host.cpp:1031``), and only the repack keeps
    the bytes right."""
    if native.get_lib().alac_pack_simd_width() != 8:
        pytest.skip("the native pair packer runs its scalar arm here (no AVX-512 "
                    "F+BW+VBMI2), so no lockstep group forms")
    rng = np.random.default_rng(16)
    frames = _music_and_noise(rng, 15)
    frames.insert(3, frames.pop())  # the noise frame into group 0
    frames[5] = rng.integers(-(1 << 14), 1 << 14, (S, 2)).astype(np.int32)
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    prep = ed._prep(frames, params, cfg, at.AlacEncoder(params, cfg))
    fetch = ed._dispatch(prep, params, cfg, torch.device("cpu"), quads=True)
    qws, qfat = fetch.get(10, 11)
    F = len(frames)
    assert F == 16 and len({(len(f), f.shape[1]) for f in frames}) == 1
    frame_fat = qfat[:F] | qfat[F:]
    assert frame_fat[3] and frame_fat.sum() <= F // 2
    groups = [qws[c * F : c * F + 8].astype(np.int64) for c in (0, 1)]  # A, B rows
    assert any(((g[3] < 0) & (g.max(axis=0) > 64)).any() for g in groups), \
        "no column of group 0 pairs a -1 lane with a > 64-bit quad"
    timings = {}
    got = ed.encode_frames_device(frames, params, cfg, timings=timings, device="cpu",
                                  quads=True)
    assert timings["quad_chunks"] == 1
    assert timings["repacked_frames"] == int(frame_fat.sum())
    assert got == _host(frames, params, cfg)


@needs_native
@pytest.mark.parametrize("route", [dict(quads=True), dict(pack="scatter")],
                         ids=["quads", "device_pack"])
def test_routes_under_a_three_shard_mesh(route):
    """Three CPU shards: the quad route (its fat frame's rows gathered
    per shard) and a device-pack request (the host packer under a mesh)
    give the single device's and the host's bytes."""
    frames = _music_and_noise(np.random.default_rng(17), 7)
    frames.insert(4, frames.pop())  # the fat frame in the middle shard
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    mesh = tmesh.Mesh(["cpu"] * 3)
    timings = {}
    got = ed.encode_frames_device(frames, params, cfg, timings=timings, mesh=mesh,
                                  **route)
    if "quads" in route:
        assert timings["quad_chunks"] == 1 and timings["repacked_frames"] == 1
    else:
        assert "device_pack_chunks" not in timings
    assert got == ed.encode_frames_device(frames, params, cfg, device="cpu", **route)
    assert got == _host(frames, params, cfg)


def test_unknown_pack_raises():
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    frames = [tone(S, 2, 16)]
    with pytest.raises(ValueError, match="pack='bogus'"):
        ed.encode_frames_device(frames, params, device="cpu", pack="bogus")
    with pytest.raises(ValueError, match="pack='bogus'"):
        at.encode_files([frames[0]], [io.BytesIO()], 44100, device="cpu", pack="bogus")


@pytest.mark.parametrize("flags", [["--pack", "scatter"], ["--pack", "gather"], ["--quads"]],
                         ids=["scatter", "gather", "quads"])
def test_cli_pack_flags_give_the_default_bytes(flags, tmp_path, capsys):
    from alacnet_tpu_torch import cli
    from alacnet_tpu_torch.pcm import write_wav

    wavs = []
    for i, seed in enumerate((1, 2)):
        wav = tmp_path / f"in{i}.wav"
        with open(wav, "wb") as f:
            write_wav(f, tone(S * 2 + 9, 2, 16, seed=seed), 44100, 16, 2)
        wavs.append(str(wav))
    base = ["--device", "cpu"]
    assert cli.main(["batch-encode", *wavs, "--out-dir", str(tmp_path / "a"), *base]) == 0
    assert cli.main(["batch-encode", *wavs, "--out-dir", str(tmp_path / "b"), *base,
                     *flags]) == 0
    assert cli.main(["encode", wavs[0], str(tmp_path / "one.m4a"), *base, *flags]) == 0
    for i in range(2):
        assert (tmp_path / "a" / f"in{i}.m4a").read_bytes() == \
            (tmp_path / "b" / f"in{i}.m4a").read_bytes()
    assert (tmp_path / "one.m4a").read_bytes() == (tmp_path / "a" / "in0.m4a").read_bytes()
    capsys.readouterr()


# ------------------------------------------ route variables (ALAC_ENC_*)

#: One setting of each route variable, and of the JAX package's pair
#: writer interleave, which the port does not read (a speed-only choice:
#: the JAX writer changes, the bytes do not).
ROUTE_ENVS = [
    {}, {"ALAC_ENC_PAIR": "0"}, {"ALAC_ENC_PAIR": "1"}, {"ALAC_ENC_QUAD": "1"},
    {"ALAC_ENC_DEVICE_PACK": "1"},
    {"ALAC_ENC_DEVICE_PACK": "1", "ALAC_ENC_PACK_IMPL": "scatter"},
    {"ALAC_ENC_DEVICE_PACK": "1", "ALAC_ENC_PACK_IMPL": "gather"},
    {"ALAC_ENC_KERNEL": "xla"},
    {"ALAC_ENC_PAIR_ILV": "2"}, {"ALAC_ENC_PAIR_ILV": "4"}, {"ALAC_ENC_PAIR_ILV": "8"},
    {"ALAC_ENC_PAIR_ILV": "auto"},
]
ROUTE_VARS = ("ALAC_ENC_KERNEL", "ALAC_ENC_PAIR", "ALAC_ENC_QUAD", "ALAC_ENC_DEVICE_PACK",
              "ALAC_ENC_PACK_IMPL", "ALAC_ENC_PAIR_ILV", "ALAC_NO_NATIVE", "ALAC_NATIVE")


def _route_frames():
    """tests/test_encode_pairs.py's interleave input: eleven 16-bit
    stereo frames, one of them mono inside an 8-frame group, one with an
    odd tail (both break the packer's lockstep)."""
    pcm = tone(S * 11, 2, 16, noise=60.0)
    frames = [pcm[i * S: (i + 1) * S] for i in range(11)]
    frames[3] = frames[3][:, :1]
    frames[9] = frames[9][: S // 2 + 3]
    return frames


@pytest.fixture
def route_env(monkeypatch):
    for name in ROUTE_VARS:
        monkeypatch.delenv(name, raising=False)

    def set_env(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    return set_env


@needs_native
@pytest.mark.parametrize("env", ROUTE_ENVS,
                         ids=["-".join(f"{k[5:]}={v}" for k, v in e.items()) or "none"
                              for e in ROUTE_ENVS])
def test_route_variable_bytes_match_jax(env, route_env, monkeypatch):
    """Each variable takes the port to the route it names (the packer that
    ran) and to the JAX encoder's bytes under the same variable."""
    frames = _route_frames()
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=4)
    route_env(env)
    packers = []
    for name in ("_pack_host", "_pack_host_pairs", "_pack_device"):
        monkeypatch.setattr(ed, name, lambda *a, name=name, real=getattr(ed, name): (
            packers.append(name) or real(*a)))
    timings = {}
    got = ed.encode_frames_device(frames, params, cfg, timings=timings, device="cpu")
    want = ("_pack_device" if "ALAC_ENC_DEVICE_PACK" in env else
            "_pack_host" if env.get("ALAC_ENC_PAIR") == "0" else "_pack_host_pairs")
    assert packers == [want]
    if "ALAC_ENC_QUAD" in env:
        assert timings["quad_chunks"] == 1
    assert got == encode_frames_tpu(frames, jax_cookie(44100, 16, 2, S),
                                    JaxEncoderConfig(order=4))
    assert got == _host(frames, params, cfg)


def test_device_pack_variable_picks_the_device_packer(route_env, monkeypatch):
    """``ALAC_ENC_PACK_IMPL`` names the device packer that runs, in the
    port and in the JAX package; unset, both take scatter."""
    frames = [tone(S, 2, 16, seed=s) for s in range(3)]
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    for impl in (None, "gather", "scatter"):
        route_env({"ALAC_ENC_DEVICE_PACK": "1", **({"ALAC_ENC_PACK_IMPL": impl} if impl else {})})
        ran = []
        for mod, name in ((tenc, "pack_frames_device"), (tenc, "pack_frames_device_scatter"),
                          (jenc, "pack_frames_device"), (jenc, "pack_frames_device_scatter")):
            monkeypatch.setattr(mod, name, lambda *a, real=getattr(mod, name), tag=(mod, name),
                                **k: ran.append(tag) or real(*a, **k))
        got = ed.encode_frames_device(frames, params, at.EncoderConfig(order=4), device="cpu")
        jgot = encode_frames_tpu(frames, jax_cookie(44100, 16, 2, S), JaxEncoderConfig(order=4))
        name = "pack_frames_device" if impl == "gather" else "pack_frames_device_scatter"
        assert ran == [(tenc, name), (jenc, name)], impl
        assert got == jgot == _host(frames, params, at.EncoderConfig(order=4))
        monkeypatch.undo()


def test_no_native_variable_bytes_match_jax(route_env, monkeypatch):
    """``ALAC_NO_NATIVE=1``: no pair planes and no native packer on either
    side (the Python packer), the same bytes."""
    from alacnet_tpu import native as jnative

    frames = _route_frames()[:4]
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    route_env({"ALAC_NO_NATIVE": "1"})
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    packed = []
    monkeypatch.setattr(ed, "_pack_py", lambda *a, real=ed._pack_py: packed.append(1) or real(*a))
    got = ed.encode_frames_device(frames, params, at.EncoderConfig(order=4), device="cpu")
    assert packed == [1]
    assert got == encode_frames_tpu(frames, jax_cookie(44100, 16, 2, S),
                                    JaxEncoderConfig(order=4))


def test_fused_kernel_variable_raises_on_the_cpu(route_env):
    """``ALAC_ENC_KERNEL=fused`` demands the CUDA kernels: the port has no
    interpreter for them, so a CPU encode raises (the JAX package would
    interpret its Pallas kernels)."""
    route_env({"ALAC_ENC_KERNEL": "fused"})
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ed.encode_frames_device([tone(S, 2, 16)], params, device="cpu")
    # an explicit kernel wins over the variable
    ed.encode_frames_device([tone(S, 2, 16)], params, device="cpu", kernel="auto")


@needs_native
@pytest.mark.parametrize("env", [{"ALAC_ENC_QUAD": "1"}, {"ALAC_ENC_PAIR": "0"}],
                         ids=["quads", "classic"])
def test_route_variables_reach_the_mesh_branch(env, route_env, monkeypatch):
    """Three CPU shards: the variables choose the mesh path's planes
    (``encode_stages_pcm_spmd(pairs=, quads=)``) as they do without one."""
    frames = _music_and_noise(np.random.default_rng(17), 7)
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    route_env(env)
    seen = []
    real = tmesh.encode_stages_pcm_spmd
    monkeypatch.setattr(tmesh, "encode_stages_pcm_spmd", lambda *a, **k: (
        seen.append((k["pairs"], k["quads"])) or real(*a, **k)))
    timings = {}
    got = ed.encode_frames_device(frames, params, cfg, timings=timings,
                                  mesh=tmesh.Mesh(["cpu"] * 3))
    assert seen[0] == ((True, True) if "ALAC_ENC_QUAD" in env else (False, False))
    assert timings.get("quad_chunks", 0) == ("ALAC_ENC_QUAD" in env)
    assert got == _host(frames, params, cfg)


@pytest.mark.parametrize("cmd", ["encode", "batch-encode"])
def test_cli_route_flags_default_to_the_variables(cmd, tmp_path, monkeypatch):
    """Left out, ``--pack`` and ``--quads`` reach the encoder as None, so
    the encoder resolves them from the variables."""
    from alacnet_tpu_torch import cli
    from alacnet_tpu_torch.codec import encoder as tencoder
    from alacnet_tpu_torch.pcm import write_wav

    class Recorded(Exception):
        pass

    def record(*a, **k):
        seen.append((k["pack"], k["quads"]))
        raise Recorded

    wav = tmp_path / "in.wav"
    with open(wav, "wb") as f:
        write_wav(f, tone(S, 2, 16), 44100, 16, 2)
    seen = []
    monkeypatch.setattr(tencoder, "encode_m4a" if cmd == "encode" else "encode_files", record)
    args = ([str(wav), str(tmp_path / "o.m4a")] if cmd == "encode"
            else [str(wav), "--out-dir", str(tmp_path / "d")])
    for flags, want in (([], (None, None)), (["--pack", "gather", "--quads"], ("gather", True))):
        seen.clear()
        with pytest.raises(Recorded):
            cli.main([cmd, *args, "--device", "cpu", *flags])
        assert seen == [want]
