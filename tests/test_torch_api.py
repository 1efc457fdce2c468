"""The port's public API over ``decode_blob`` against the JAX package's,
on the CPU, exact equality: ``AlacContext``, ``ALACFileReader``,
``decode_resumable``, the WAV helpers and the CLI, each driven the same
way over the same bytes on both sides (the cases of tests/test_api.py).

The plain ``rice_lpc`` loops over samples (about 1 ms a step), so the
fixtures use 256-sample frames and the sessions small windows, which the
reads and seeks cross.
"""

import dataclasses
import io
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import alacnet_tpu  # noqa: E402
import alacnet_tpu_torch  # noqa: E402
from alacnet_tpu import cli as jcli  # noqa: E402
from alacnet_tpu.codec.cookie import default_cookie as j_cookie  # noqa: E402
from alacnet_tpu.codec.encoder import AlacEncoder as JEncoder  # noqa: E402
from alacnet_tpu.codec.encoder import EncoderConfig  # noqa: E402
from alacnet_tpu.container.mux import write_m4a as j_write_m4a  # noqa: E402
from alacnet_tpu_torch import cli as tcli  # noqa: E402
from alacnet_tpu_torch import pcm as tpcm  # noqa: E402

from .corpus import encode_to_bytes, tone  # noqa: E402

FS = 256  # samples per frame
N = FS * 9 + 100  # ten frames, the last one partial


@pytest.fixture(scope="module")
def stereo16():
    pcm = tone(N, 2, 16)
    return pcm, encode_to_bytes(pcm, 44100, 16, EncoderConfig(order=6),
                                max_samples_per_frame=FS)


@pytest.fixture(scope="module")
def hires24():
    pcm = tone(FS * 3 + 17, 2, 24, noise=2000.0)
    return pcm, encode_to_bytes(pcm, 96000, 24, EncoderConfig(order=4),
                                max_samples_per_frame=FS)


def contexts(data, window=3):
    """The same stream as a JAX and as a port AlacContext."""
    return (alacnet_tpu.AlacContext(io.BytesIO(data), window=window),
            alacnet_tpu_torch.AlacContext(io.BytesIO(data), window=window, device="cpu"))


def readers(data, window=4):
    cfg = alacnet_tpu_torch.DecodeConfig(device="cpu", stream_window=window)
    return (alacnet_tpu.ALACFileReader(io.BytesIO(data)),
            alacnet_tpu_torch.ALACFileReader(io.BytesIO(data), config=cfg))


def both(objs, fn):
    """fn on each object; the two results must be equal; returns the
    port's."""
    j, t = (fn(o) for o in objs)
    if isinstance(j, np.ndarray):
        np.testing.assert_array_equal(t, j)
        assert t.dtype == j.dtype
    else:
        assert t == j
    return t


class TestAlacContext:
    def test_metadata(self, stereo16):
        pcm, data = stereo16
        ctxs = contexts(data)
        for get in ("get_sample_rate", "get_num_channels", "get_bits_per_sample",
                    "get_bytes_per_sample", "get_num_samples"):
            both(ctxs, lambda c: getattr(c, get)())
        assert both(ctxs, lambda c: c.num_frames) == 10
        assert ctxs[1].get_num_samples() == pcm.shape[0]

    def test_read_frames_sequential(self, stereo16):
        pcm, data = stereo16
        ctxs = contexts(data)
        np.testing.assert_array_equal(both(ctxs, lambda c: c.read_all()), pcm)
        assert both(ctxs, lambda c: c.read_frame().size) == 0  # EOF
        assert both(ctxs, lambda c: c.read()) == b""

    def test_read_bytes_matches_reference_format(self, stereo16):
        pcm, data = stereo16
        ctxs = contexts(data)
        first = both(ctxs, lambda c: c.read())
        np.testing.assert_array_equal(tpcm.parse_pcm_bytes(first, 2, 2), pcm[:FS])
        assert both(ctxs, lambda c: c.last_sample_number) == FS

    def test_seek_mid_frame_trims_offset(self, stereo16):
        pcm, data = stereo16
        ctxs = contexts(data)
        for c in ctxs:
            c.set_position(FS + 44)  # inside frame 1
        assert both(ctxs, lambda c: c.last_sample_number) == 2 * FS
        got = both(ctxs, lambda c: c.read_frame())
        np.testing.assert_array_equal(got, pcm[FS + 44 : 2 * FS])
        assert both(ctxs, lambda c: c.last_sample_number) == 3 * FS

    def test_seek_past_eof_is_noop(self, stereo16):
        _, data = stereo16
        ctxs = contexts(data)
        both(ctxs, lambda c: c.read_frame())
        before = ctxs[1].last_sample_number
        for c in ctxs:
            c.set_position(10**9)
        assert both(ctxs, lambda c: c.last_sample_number) == before

    def test_seek_backwards_and_forwards(self, stereo16):
        pcm, data = stereo16
        ctxs = contexts(data)
        for c in ctxs:
            c.set_position(9 * FS + 30)
        a = both(ctxs, lambda c: c.read_frame())
        for c in ctxs:
            c.set_position(10)
        b = both(ctxs, lambda c: c.read_frame())
        np.testing.assert_array_equal(a, pcm[9 * FS + 30 :])
        np.testing.assert_array_equal(b, pcm[10:FS])

    def test_set_position_clamp_to_eof(self, stereo16):
        _, data = stereo16
        ctxs = contexts(data)
        for c in ctxs:
            c.set_position(10**9, clamp_to_eof=True)
        assert both(ctxs, lambda c: c.last_sample_number) == N
        assert both(ctxs, lambda c: c.read()) == b""
        assert ctxs[1].dispose == ctxs[1].close  # the reference's name


class TestALACFileReader:
    def test_wave_format_and_length(self, stereo16, hires24):
        for pcm, data in (stereo16, hires24):
            rs = readers(data)
            wf = both(rs, lambda r: dataclasses.astuple(r.wave_format))
            wf = rs[1].wave_format
            assert both(rs, lambda r: r.length) == pcm.shape[0] * wf.block_align
            assert both(rs, lambda r: r.total_time) == pytest.approx(
                pcm.shape[0] / wf.sample_rate)
            assert isinstance(wf, alacnet_tpu_torch.WaveFormat)

    def test_chunked_reads_arbitrary_sizes(self, stereo16):
        pcm, data = stereo16
        rs = readers(data)
        chunks, sizes = [], [1, 3, 1025, 64, 100000, 5]
        i = 0
        while True:
            c = both(rs, lambda r: r.read(sizes[i % len(sizes)]))
            i += 1
            if not c:
                break
            chunks.append(c)
        np.testing.assert_array_equal(tpcm.parse_pcm_bytes(b"".join(chunks), 2, 2), pcm)

    def test_reposition_mid_stream(self, stereo16):
        pcm, data = stereo16
        rs = readers(data)
        both(rs, lambda r: r.read(999))  # fill leftovers
        for r in rs:
            r.position = r.length // 2
        half = (rs[1].length // 2) // 4
        got = both(rs, lambda r: r.read(400))
        np.testing.assert_array_equal(tpcm.parse_pcm_bytes(got, 2, 2), pcm[half : half + 100])

    def test_position_reflects_last_sample(self, stereo16):
        _, data = stereo16
        rs = readers(data)
        both(rs, lambda r: r.read(10))
        assert both(rs, lambda r: r.position) == FS * 4

    def test_readinto(self, stereo16):
        pcm, data = stereo16
        rs = readers(data)
        bufs = [bytearray(100), bytearray(100)]
        assert [r.readinto(b, 0, 100) for r, b in zip(rs, bufs)] == [100, 100]
        assert bufs[0] == bufs[1]
        np.testing.assert_array_equal(tpcm.parse_pcm_bytes(bytes(bufs[1]), 2, 2), pcm[:25])

    def test_stdlib_io_interop(self, stereo16):
        pcm, data = stereo16
        rs = readers(data)
        r = rs[1]
        assert r.readable() and r.seekable() and not r.writable()
        assert both(rs, lambda r: r.seek(400)) == 400
        got = both(rs, lambda r: r.read(40))
        np.testing.assert_array_equal(tpcm.parse_pcm_bytes(got, 2, 2), pcm[100:110])
        sinks = []
        for r in rs:
            r.seek(0)
            sinks.append(io.BytesIO())
            shutil.copyfileobj(r, sinks[-1], length=8192)
        assert sinks[0].getvalue() == sinks[1].getvalue()
        np.testing.assert_array_equal(tpcm.parse_pcm_bytes(sinks[1].getvalue(), 2, 2), pcm)

    def test_seek_whence(self, stereo16):
        pcm, data = stereo16
        rs = readers(data)
        both(rs, lambda r: r.seek(100))
        assert both(rs, lambda r: r.seek(40, 1)) == 140
        assert both(rs, lambda r: r.seek(-4, 2)) == rs[1].length - 4
        got = both(rs, lambda r: r.read(10))
        np.testing.assert_array_equal(tpcm.parse_pcm_bytes(got, 2, 2), pcm[-1:])
        with pytest.raises(ValueError):
            rs[1].seek(0, 3)

    def test_seek_to_eof_reads_empty(self, stereo16):
        _, data = stereo16
        rs = readers(data)
        both(rs, lambda r: r.read(64))
        assert both(rs, lambda r: r.seek(0, 2)) == rs[1].length
        assert both(rs, lambda r: r.read(100)) == b""
        assert both(rs, lambda r: r.seek(r.length + 999)) == rs[1].length + 999
        assert both(rs, lambda r: r.read(1)) == b""

    def test_random_seek_read_interleaving(self, stereo16):
        """Random seek/read sequences (fixed seed) return the same bytes
        from both packages, and exactly the PCM at the reader position."""
        pcm, data = stereo16
        ref = pcm.astype("<i2").tobytes()
        rng = np.random.default_rng(0xC0FFEE)
        rs = readers(data, window=64)  # the default: one window, many seeks
        ba, length, pos = 4, rs[1].length, 0
        for _ in range(20):
            if rng.random() < 0.4:
                pos = int(rng.integers(0, length // ba + 1)) * ba
                for r in rs:
                    r.position = pos
            want = int(rng.integers(0, 3000))
            got = both(rs, lambda r: r.read(want))
            assert got == ref[pos : pos + want]
            pos += len(got)
        for r in rs:
            r.close()


class TestMalformedInputTermination:
    def test_read_all_terminates_on_stts_undercoverage(self):
        """stts covers 2 of 4 frames: both packages decode the covered
        frames and park at EOF."""
        params = j_cookie(44100, 16, 2, max_samples_per_frame=FS)
        enc = JEncoder(params, EncoderConfig(order=4))
        pcm = tone(FS * 4, 2, 16)
        frames = [enc.encode_frame(pcm[i * FS : (i + 1) * FS]) for i in range(4)]
        buf = io.BytesIO()
        j_write_m4a(buf, params, frames, [FS, FS])
        ctxs = contexts(buf.getvalue())
        out = both(ctxs, lambda c: c.read_all())
        assert out.shape[0] == 2 * FS
        assert both(ctxs, lambda c: c.read()) == b""

    def test_sparse_chunk_gaps(self):
        """Chunk gaps of 8 MB: the window takes the per-frame read path."""
        params = j_cookie(44100, 16, 2, max_samples_per_frame=64)
        enc = JEncoder(params, EncoderConfig(order=2))
        pcm = tone(64 * 6, 2, 16)
        frames = [enc.encode_frame(pcm[i * 64 : (i + 1) * 64]) for i in range(6)]
        buf = io.BytesIO()
        j_write_m4a(buf, params, frames, [64] * 6, frames_per_chunk=2, chunk_gap=8 << 20)
        ctxs = contexts(buf.getvalue(), window=6)
        np.testing.assert_array_equal(both(ctxs, lambda c: c.read_all()), pcm)


class TestReadahead:
    def test_sequential_read_uses_prefetched_windows(self, stereo16):
        pcm, data = stereo16
        ctx = alacnet_tpu_torch.AlacContext(io.BytesIO(data), window=2, device="cpu")
        got, armed = [], False
        while True:
            fr = ctx.read_frame()
            if fr.size == 0:
                break
            got.append(fr)
            armed = armed or ctx._prefetch is not None
        ctx.close()
        assert armed, "readahead never armed"
        assert ctx.prefetch_hits == 4  # windows 1..4 of 0..4 came from it
        assert ctx._executor is None
        np.testing.assert_array_equal(np.concatenate(got), pcm)

    def test_seek_discards_stale_prefetch(self, stereo16):
        pcm, data = stereo16
        ctx = alacnet_tpu_torch.AlacContext(io.BytesIO(data), window=2, device="cpu")
        ctx.read_frame()  # window 0 decoded; window 2 prefetched
        assert ctx._prefetch is not None and ctx._prefetch[0] == 2
        fr = ctx._frame_samples(7)  # jump: the stale prefetch is dropped
        np.testing.assert_array_equal(fr, pcm[7 * FS : 8 * FS])
        assert ctx.prefetch_hits == 0
        ctx.close()

    def test_close_with_window_in_flight(self, stereo16):
        """close() waits for the readahead: no worker is left running."""
        _, data = stereo16
        ctx = alacnet_tpu_torch.AlacContext(io.BytesIO(data), window=2, device="cpu")
        ctx.read_frame()
        fut = ctx._prefetch[1]
        ctx.close()
        assert fut.done()


@pytest.mark.parametrize("chunk", [3, 4096])
def test_decode_resumable_matches_jax(tmp_path, stereo16, chunk):
    pcm, data = stereo16
    path = tmp_path / "r.m4a"
    path.write_bytes(data)
    jc = alacnet_tpu.DecodeCursor(str(path))
    tc = alacnet_tpu_torch.DecodeCursor(str(path))
    parts = []
    while not tc.done:
        jpart, jc = alacnet_tpu.decode_resumable(jc, max_frames=chunk)
        tpart, tc = alacnet_tpu_torch.decode_resumable(tc, max_frames=chunk, device="cpu")
        np.testing.assert_array_equal(tpart.pcm, jpart.pcm)
        assert tpart.pcm.dtype == jpart.pcm.dtype
        assert tc.next_frame == jc.next_frame and tpart.path == jpart.path
        np.testing.assert_array_equal(tpart.bad_frames, jpart.bad_frames)
        parts.append(tpart.pcm)
    assert jc.done
    np.testing.assert_array_equal(np.concatenate(parts), pcm)
    # Past the end: an empty chunk, no decode.
    tail, after = alacnet_tpu_torch.decode_resumable(
        alacnet_tpu_torch.DecodeCursor(str(path), 10), device="cpu")
    jtail, jafter = alacnet_tpu.decode_resumable(alacnet_tpu.DecodeCursor(str(path), 10))
    assert tail.pcm.shape == jtail.pcm.shape == (0, 2)
    assert after.done and jafter.done


@pytest.mark.parametrize("bits,rate", [(16, 44100), (24, 96000)])
def test_wav_roundtrip(bits, rate):
    pcm = tone(1000, 2, bits, noise=2000.0 if bits == 24 else 60.0)
    bufs = [io.BytesIO(), io.BytesIO()]
    alacnet_tpu.write_wav(bufs[0], pcm, rate, bits, 2)
    alacnet_tpu_torch.write_wav(bufs[1], pcm, rate, bits, 2)
    assert bufs[0].getvalue() == bufs[1].getvalue()
    bufs[1].seek(0)
    got, r, b = alacnet_tpu_torch.read_wav(bufs[1])
    assert (r, b) == (rate, bits)
    np.testing.assert_array_equal(got, pcm)
    assert alacnet_tpu_torch.format_pcm_bytes(pcm, bits // 8) == \
        alacnet_tpu.format_pcm_bytes(pcm, bits // 8)
    assert tpcm.format_pcm_bytes(np.array([[1, -1]], np.int32), 3) == \
        bytes([1, 0, 0, 0xFF, 0xFF, 0xFF])


def _files(tmp_path, names):
    return [(tmp_path / n).read_bytes() for n in names]


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory, stereo16, hires24):
    d = tmp_path_factory.mktemp("cli")
    (d / "s16.m4a").write_bytes(stereo16[1])
    (d / "h24.m4a").write_bytes(hires24[1])
    (d / "short.m4a").write_bytes(encode_to_bytes(tone(600, 2, 16), 44100, 16))
    params = j_cookie(44100, 16, 2)
    with open(d / "empty.m4a", "wb") as f:
        j_write_m4a(f, params, [], [])
    for name, pcm in (("a.wav", tone(700, 2, 16)), ("b.wav", tone(500, 1, 16, seed=3))):
        with open(d / name, "wb") as f:
            alacnet_tpu.write_wav(f, pcm, 44100, 16, pcm.shape[1])
    return d


def _run_both(tmp_path, argv_of):
    """Run the JAX and the port CLI; argv_of(side_dir, side) gives each
    side's argument list.  Both must return the same code."""
    rcs = []
    for side, main in (("jax", jcli.main), ("torch", tcli.main)):
        out = tmp_path / side
        out.mkdir(exist_ok=True)
        rcs.append(main(argv_of(out, side)))
    assert rcs[0] == rcs[1]
    return rcs[1]


@pytest.mark.parametrize("extra", [[], ["--seek-middle"], ["--stream", "3"], ["--stream"]])
@pytest.mark.parametrize("name", ["s16.m4a", "h24.m4a"])
def test_cli_decode_matches_jax(tmp_path, cli_inputs, name, extra):
    dev = lambda side: ["--device", "cpu"] if side == "torch" else []  # noqa: E731
    assert _run_both(tmp_path, lambda o, s: ["decode", str(cli_inputs / name),
                                             str(o / "x.wav"), *extra, *dev(s)]) == 0
    j, t = _files(tmp_path, ["jax/x.wav", "torch/x.wav"])
    assert j == t and len(t) > 44


def test_cli_decode_stream_zero_frames(tmp_path, cli_inputs):
    dev = lambda side: ["--device", "cpu"] if side == "torch" else []  # noqa: E731
    assert _run_both(tmp_path, lambda o, s: ["decode", str(cli_inputs / "empty.m4a"),
                                             str(o / "e.wav"), "--stream", *dev(s)]) == 0
    j, t = _files(tmp_path, ["jax/e.wav", "torch/e.wav"])
    assert j == t and len(t) == 44


def test_cli_info_matches_jax(cli_inputs, capsys):
    outs = []
    for main in (jcli.main, tcli.main):
        assert main(["info", str(cli_inputs / "h24.m4a")]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "96000 Hz" in outs[1]


@pytest.mark.parametrize("where", [["--host"], ["--device", "cpu"]], ids=["host", "cpu"])
def test_cli_encode_matches_jax(tmp_path, cli_inputs, where):
    """``encode``: the host encoder with --host, else the device stages
    on --device; the bytes are the JAX CLI's either way."""
    def argv(o, side):
        args = ["encode", str(cli_inputs / "a.wav"), str(o / "a.m4a"), "--order", "4"]
        return args + where if side == "torch" else args

    assert _run_both(tmp_path, argv) == 0
    j, t = _files(tmp_path, ["jax/a.m4a", "torch/a.m4a"])
    assert j == t


def test_cli_batch_encode_and_decode_match_jax(tmp_path, cli_inputs):
    wavs = [str(cli_inputs / n) for n in ("a.wav", "b.wav")]
    dev = lambda side: ["--device", "cpu"] if side == "torch" else []  # noqa: E731
    assert _run_both(tmp_path, lambda o, s: ["batch-encode", *wavs, "--out-dir",
                                             str(o / "m4a"), *dev(s)]) == 0
    for n in ("a.m4a", "b.m4a"):
        j, t = _files(tmp_path, [f"jax/m4a/{n}", f"torch/m4a/{n}"])
        assert j == t
    m4as = [str(cli_inputs / "s16.m4a"), str(cli_inputs / "h24.m4a"),
            str(tmp_path / "torch" / "m4a" / "b.m4a")]
    for extra in ([], ["--lenient"]):
        assert _run_both(tmp_path, lambda o, s: ["batch-decode", *m4as, "--out-dir",
                                                 str(o / "wav"), *extra, *dev(s)]) == 0
        for n in ("s16.wav", "h24.wav", "b.wav"):
            j, t = _files(tmp_path, [f"jax/wav/{n}", f"torch/wav/{n}"])
            assert j == t


def test_cli_verify_and_stats(tmp_path, cli_inputs, capsys):
    path = str(cli_inputs / "short.m4a")
    assert jcli.main(["verify", path]) == tcli.main(["verify", path, "--device", "cpu"]) == 0
    outs = capsys.readouterr().out.splitlines()
    assert outs[0] == outs[1] and outs[1].startswith("OK")
    assert tcli.main(["stats", path, "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["files"] == 1 and stats["samples"] == 600
