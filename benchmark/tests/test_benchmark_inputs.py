"""The frozen inputs: deterministic per seed, the same sizes for every
seed, byte-equal to the port's own encoder and muxer, decoded by the
port back to their source PCM, and free of any import of the port."""

from __future__ import annotations

import ast
import io
import subprocess
import sys

import numpy as np
import pytest
from conftest import REPO, SEED, tiny_config

from benchmark.inputs import alac, library, m4a


@pytest.mark.parametrize("name", ["cd16", "hires24"])
def test_library_is_deterministic_per_seed(name):
    c = tiny_config(name)
    a, b = library.make_library(c, SEED), library.make_library(c, SEED)
    assert np.array_equal(a.pool_pcm, b.pool_pcm)
    assert all(np.array_equal(x, y) for x, y in zip(a.tracks, b.tracks))
    ca, cb = a.code(), b.code()
    assert ca.payloads == cb.payloads
    assert a.m4a(ca, 0) == b.m4a(cb, 0)
    other = library.make_library(c, SEED + 1)
    assert not np.array_equal(a.pool_pcm, other.pool_pcm)


def test_every_seed_gets_the_same_sizes():
    c = tiny_config("cd16")
    sizes = [sorted(library.make_library(c, s).samples(t) for t in range(c["tracks"]))
             for s in (1, 2**31 + 11, 2**33 + 7)]
    assert sizes[0] == sizes[1] == sizes[2]


def _port_frame(params, pcm, order, ub):
    from alacnet_tpu_torch.codec.encoder import AlacEncoder, EncoderConfig

    return AlacEncoder(params, EncoderConfig(order=order, uncompressed_bytes=ub)).encode_frame(
        pcm.astype(np.int32))


@pytest.mark.parametrize("bits,ub,channels", [(16, 0, 2), (24, 1, 2), (16, 0, 1)])
def test_frozen_encoder_equals_the_ports(bits, ub, channels):
    """Full, partial, one-sample and silent frames, orders 4, 6 and 8."""
    from alacnet_tpu_torch.codec.cookie import default_cookie

    from benchmark.inputs import pcm as pcm_mod

    S = 512
    rng = np.random.default_rng(3)
    frames = pcm_mod.music_frames(6, S, bits, channels, rng, dither=400 if ub else 0)
    n = np.array([S, S, 200, 1, S, 37])
    for f in range(6):
        frames[f, n[f]:] = 0
    frames[4] = 0
    orders = np.array([4, 8, 6, 4, 8, 6])
    coded = alac.encode_frames(frames, n, orders, alac.FrameCoding(
        sample_size=bits, max_samples_per_frame=S, uncompressed_bytes=ub))
    params = default_cookie(44100, bits, channels, S)
    for f in range(6):
        assert coded.payloads[f] == _port_frame(params, frames[f, : n[f]], orders[f], ub), f


@pytest.mark.parametrize("bits,ub", [(16, 0), (24, 1)])
def test_each_channel_takes_the_cheaper_order(bits, ub):
    """Given candidates, each channel is coded at the order whose Rice
    section and coefficients cost fewer bits; a frame whose channels agree
    is the frame coded at that order alone."""
    from benchmark.inputs import pcm as pcm_mod

    S = 512
    frames = pcm_mod.music_frames(12, S, bits, 2, np.random.default_rng(5), dither=400 if ub else 0)
    frames[3] = 0
    n = np.full(12, S)
    coding = alac.FrameCoding(sample_size=bits, max_samples_per_frame=S, uncompressed_bytes=ub)
    fixed = {o: alac.encode_frames(frames, n, o, coding) for o in (4, 8)}
    chosen = alac.encode_frames(frames, n, (8, 4), coding)
    cost = {o: fixed[o].rice_bits + 16 * o for o in (4, 8)}
    assert np.array_equal(chosen.orders, np.where(cost[8] < cost[4], 8, 4))
    assert np.array_equal(chosen.rice_bits, np.where(chosen.orders == 8, fixed[8].rice_bits,
                                                     fixed[4].rice_bits))
    assert {4, 8} <= set(chosen.orders.ravel().tolist())
    for f in range(12):
        o = chosen.orders[f]
        if o[0] == o[1]:
            assert chosen.payloads[f] == fixed[int(o[0])].payloads[f], f
        assert len(chosen.payloads[f]) <= min(len(fixed[4].payloads[f]),
                                              len(fixed[8].payloads[f])) + 1


def test_rice_bits_account_for_every_payload_bit():
    c = tiny_config("hires24")
    lib = library.make_library(c, SEED)
    coded = lib.code()
    for i, p in enumerate(coded.payloads):
        n = int(lib.pool_n[i])
        head = 3 + 4 + 12 + 1 + 2 + 1 + (32 if n != c["frame_samples"] else 0) + 16
        head += sum(16 + 16 * int(order) for order in coded.orders[i])
        bits = head + n * 2 * 8 + int(coded.rice_bits[i].sum())
        assert len(p) == -(-bits // 8)


def test_frozen_muxer_equals_the_ports():
    from alacnet_tpu_torch.codec.cookie import default_cookie
    from alacnet_tpu_torch.container.mux import write_m4a

    frames = [bytes([i]) * (100 + 13 * i) for i in range(23)]
    durations = [4096] * 22 + [1234]
    out = io.BytesIO()
    write_m4a(out, default_cookie(96000, 24, 2, 4096), frames, durations)
    assert m4a.write_m4a(96000, 24, 2, 4096, frames, durations) == out.getvalue()


@pytest.mark.parametrize("name", ["cd16", "hires24"])
def test_port_decodes_the_library_to_its_source(name):
    """A rehearsal at a tiny size with the port's plain torch versions on
    the host (no number of it is a device's)."""
    from alacnet_tpu_torch import decode_streams

    lib = library.make_library(tiny_config(name), SEED)
    coded = lib.code()
    files = [io.BytesIO(lib.m4a(coded, t)) for t in range(2)]
    out = decode_streams(files, device="cpu")
    for t, got in enumerate(out):
        assert got.bits_per_sample == lib.config["bits_per_sample"]
        assert np.array_equal(got.pcm, lib.track_pcm(t))


def test_frozen_code_imports_nothing_of_the_port():
    frozen = ["inputs/alac.py", "inputs/library.py", "inputs/m4a.py", "inputs/pcm.py",
              "yardstick.py", "device_trace.py"]
    for rel in frozen:
        tree = ast.parse((REPO / "benchmark" / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", None) or ""]
                assert not any(n.startswith("alacnet_tpu") for n in names), rel
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.inputs.library, "
            "benchmark.yardstick; print(sorted(m for m in sys.modules if m.startswith('alacnet')))")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
