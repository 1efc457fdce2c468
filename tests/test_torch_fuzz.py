"""The port's ``decode_frames`` under the randomized differential fuzz, on
the CPU: tolerance 0, every lane.

The port of ``tests/test_fuzz_differential.py::test_randomized_differential_fuzz``
at its counts and seeds (1,536 16-bit and 768 24-bit frames of 64
samples, seeds 101 and 202): structurally valid headers over random
entropy bodies, every order and quantisation, ``hassize`` short frames,
truncated and oversized bodies.  The frames come from the port's copy of
the generator (``scripts/soak_torch.fuzz_payloads``), held byte for byte
to the reference test's.  Each lane of the port's ``decode_frames``
(plain torch versions) must equal the JAX package's ``decode_frames``
(its XLA path) and the port's scalar oracle; ``decode_frames`` must
equal ``decode_frames_packed``, here and on ``__graft_entry__``'s tiny
8 x 256 batch.  On the CPU the port's plain path and the JAX XLA path
clip a cursor that leaves its word row alike, so no lane is left out.
"""

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from alacnet_tpu.codec.cookie import default_cookie as jax_cookie  # noqa: E402
from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec as jax_parse  # noqa: E402
from alacnet_tpu.ops import frame_decode as jfd  # noqa: E402

from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec  # noqa: E402
from alacnet_tpu_torch.codec.scalar import AlacFrameDecoder  # noqa: E402
from alacnet_tpu_torch.ops.frame_decode import (  # noqa: E402
    FrameMetaArrays, decode_frames, decode_frames_packed,
)

from .test_fuzz_differential import _random_payload  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
import soak_torch  # noqa: E402

BATCHES = soak_torch.FUZZ_BATCHES
S = soak_torch.FUZZ_SAMPLES


def port_oracle(params, payload: bytes, nch: int) -> np.ndarray:
    """The port's scalar decode of one payload -> (n, nch) int32."""
    dec = AlacFrameDecoder(params, nch)
    out = [0] * (params.max_samples_per_frame * nch * 3 + 16)
    nbytes = dec.decode_frame(payload, out)
    ss = params.sample_size
    n = nbytes // ((ss // 8) * nch)
    if ss == 16:
        return np.array(out[: n * nch], np.int32).reshape(-1, nch)
    b = np.array(out[: n * nch * 3], np.int64).reshape(-1, nch, 3)
    vals = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    return np.where(vals >= 1 << 23, vals - (1 << 24), vals).astype(np.int32)


@pytest.fixture(scope="module", params=BATCHES, ids=[f"{b}bit" for b, _, _ in BATCHES])
def fuzz(request):
    """(payloads, channels, port params, port FrameBatch, port decode)."""
    bits, count, seed = request.param
    payloads, nchs, params = soak_torch.fuzz_payloads(bits, count, seed)
    fb = parse_frame_headers_vec(payloads, params)
    assert not fb.status.any(), "fuzz headers must parse cleanly"
    words = torch.from_numpy(fb.words.view(np.int32))
    out, n = decode_frames(words, FrameMetaArrays.from_batch(fb, "cpu"), S)
    return payloads, nchs, params, fb, out.numpy(), n.numpy(), request.param


def test_generator_is_the_reference_generator(fuzz):
    payloads, nchs, _, _, _, _, (bits, count, seed) = fuzz
    rng = np.random.default_rng(seed)
    params = jax_cookie(96000 if bits == 24 else 44100, bits, 2, max_samples_per_frame=S)
    want = [_random_payload(rng, params, bits) for _ in range(count)]
    assert payloads == [p for p, _ in want]
    assert nchs == [c for _, c in want]


def test_decode_frames_matches_jax_every_lane(fuzz):
    payloads, _, _, _, out, n, (bits, _, _) = fuzz
    params = jax_cookie(96000 if bits == 24 else 44100, bits, 2, max_samples_per_frame=S)
    jfb = jax_parse(payloads, params)
    jout, jn = jfd.decode_frames(jnp.asarray(jfb.words), jfd.FrameMetaArrays.from_batch(jfb), S)
    np.testing.assert_array_equal(n, np.asarray(jn))
    jout = np.asarray(jout)
    for lane in range(len(payloads)):
        np.testing.assert_array_equal(out[lane], jout[lane], err_msg=f"lane {lane}")


def test_decode_frames_matches_the_scalar_oracle(fuzz):
    payloads, nchs, params, _, out, n, _ = fuzz
    for lane, (p, nch) in enumerate(zip(payloads, nchs)):
        want = port_oracle(params, p, nch)
        assert n[lane] == want.shape[0], f"lane {lane}: n"
        np.testing.assert_array_equal(out[lane, : want.shape[0], :nch], want,
                                      err_msg=f"lane {lane}")
        assert not out[lane, want.shape[0]:].any(), f"lane {lane}: past n"


def test_decode_frames_equals_decode_frames_packed(fuzz):
    _, _, _, fb, out, n, _ = fuzz
    got, gn = decode_frames_packed(torch.from_numpy(fb.words.view(np.int32)),
                                   FrameMetaArrays.pack_host(fb), S)
    np.testing.assert_array_equal(got.numpy(), out)
    np.testing.assert_array_equal(gn.numpy(), n)


@pytest.mark.parametrize("emit16", [False, True])
def test_graft_entry_batch(emit16):
    """``__graft_entry__.entry()``'s tiny batch (8 frames of 256 samples):
    the JAX ``decode_frames``, the port's ``decode_frames`` and its
    ``decode_frames_packed`` on the same arrays, and the source PCM."""
    fn, (words, meta) = __graft_entry__.entry()
    jout, jn = fn(words, meta)
    fb, frame_samples, pcm = __graft_entry__._tiny_batch(num_frames=8, frame_samples=256)
    tw = torch.from_numpy(np.asarray(fb.words).view(np.int32))
    out, n = decode_frames(tw, FrameMetaArrays.from_batch(fb, "cpu"), frame_samples,
                           emit16=emit16)
    pout, pn = decode_frames_packed(tw, FrameMetaArrays.pack_host(fb), frame_samples,
                                    emit16=emit16)
    assert out.dtype == (torch.int16 if emit16 else torch.int32)
    np.testing.assert_array_equal(out.numpy(), pout.numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(pn.numpy(), n.numpy())
    np.testing.assert_array_equal(out.numpy().reshape(-1, 2), pcm)


def test_fuzz_routes_on_the_cpu():
    """``soak_torch.fuzz_routes``, which holds the CUDA kernels to the
    plain versions on the card, here with two routes that both run the
    plain versions: every lane equal, the clipped ones counted apart."""
    recs = soak_torch.fuzz_routes("cpu", routes=("torch", "auto"),
                                  batches=((16, 256, 101), (24, 128, 202)))
    for rec in recs:
        assert rec["equal"] and rec["n_equal"] and rec["clipped_differing"] == 0
        assert rec["compared"] + rec["clipped"] == rec["lanes"]
        assert rec["compared"] > 0.9 * rec["lanes"]


@pytest.mark.parametrize("bits,count,seed", [(16, 128, 101), (24, 64, 202)])
def test_decode_frames_returns_its_entropy_cursors(bits, count, seed):
    """``decode_frames(return_ends=True)``: the same samples, and the bits
    where channel A's and channel B's Rice decodes ended, channel B
    starting where A ended (``fused_rice_lpc`` run alone, channel by
    channel)."""
    from alacnet_tpu_torch.ops.cuda.rice_lpc import fused_rice_lpc

    payloads, _, params = soak_torch.fuzz_payloads(bits, count, seed)
    fb = parse_frame_headers_vec(payloads, params)
    words = torch.from_numpy(fb.words.view(np.int32))
    m = FrameMetaArrays.from_batch(fb, "cpu")
    out, n, (end_a, end_b) = decode_frames(words, m, S, return_ends=True)
    out2, n2 = decode_frames(words, m, S)
    np.testing.assert_array_equal(out.numpy(), out2.numpy())
    np.testing.assert_array_equal(n.numpy(), n2.numpy())
    n_a = torch.where(m.is_compressed, torch.clamp(m.n_samples, 0, S), 0)
    start = m.entropy_pos
    for c, (n_c, end) in enumerate(((n_a, end_a), (torch.where(m.is_stereo, n_a, 0), end_b))):
        _, want = fused_rice_lpc(words, start, n_c, m.rss, m.kmod, m.init_history,
                                 m.rice_mult[:, c], m.kmask, m.order[:, c], m.quant[:, c],
                                 m.rc[:, c].contiguous(), S)
        np.testing.assert_array_equal(end.numpy(), want.numpy())
        start = torch.clamp(want, min=0)
    assert (end_b >= torch.clamp(end_a, min=0)).all()
