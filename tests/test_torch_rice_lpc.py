"""Kernel 2's plain version against the JAX package's XLA path.

The ``fused_rice_lpc`` wrapper on CPU tensors runs ``rice.rice_decode``
then ``lpc.lpc_decode``; here it is held against the JAX
``rice_decode`` + ``lpc_decode`` (the path tests/test_pallas_kernel.py
holds equal to the Pallas kernel), one channel at a time, comparing the
samples and the end bit positions exactly.  Channel B starts at A's end.
"""

import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.codec.cookie import default_cookie  # noqa: E402
from alacnet_tpu.codec.encoder import AlacEncoder  # noqa: E402
from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec  # noqa: E402
from alacnet_tpu.ops.lpc import LpcParams, lpc_decode  # noqa: E402
from alacnet_tpu.ops.rice import RiceParams, rice_decode  # noqa: E402
from alacnet_tpu_torch.ops.cuda.rice_lpc import fused_rice_lpc  # noqa: E402

from .corpus import standard_cases  # noqa: E402

CASES = standard_cases()
W_PAD = 1024  # one word width for every small case: one JAX compile per S


@functools.partial(jax.jit, static_argnames=("S",))
def _jax_channel(words, start, n, rss, kmod, ihist, mult, kmask, order, quant, rc, S):
    err, end = rice_decode(words, start, n, RiceParams(rss, kmod, ihist, mult, kmask), S)
    return lpc_decode(err, n, LpcParams(order, quant, rc, rss), S), end


def _channels(fb, S):
    """Both channels through JAX and the port; yields (c, jax, port)."""
    words = fb.words
    B = words.shape[0]
    n = np.clip(fb.n_samples, 0, S)
    n_comp = np.where(fb.is_compressed, n, 0).astype(np.int32)
    n_b = np.where(fb.is_stereo, n_comp, 0).astype(np.int32)
    tw = torch.from_numpy(words.view(np.int32).copy())
    start = fb.entropy_pos.astype(np.int32)
    for c, nc in ((0, n_comp), (1, n_b)):
        cols = (fb.rss, fb.kmod, fb.init_history, fb.rice_mult[:, c], fb.kmask,
                fb.order[:, c], fb.quant[:, c])
        cols = [np.ascontiguousarray(x, np.int32) for x in cols]
        rc = np.ascontiguousarray(fb.rc[:, c], np.int32)
        j_out, j_end = _jax_channel(
            jnp.asarray(words), jnp.asarray(start), jnp.asarray(nc),
            *map(jnp.asarray, cols), jnp.asarray(rc), S=S,
        )
        t = lambda a: torch.from_numpy(np.array(a, np.int32))  # noqa: E731
        t_out, t_end = fused_rice_lpc(
            tw, t(start), t(nc), *map(t, cols), t(rc), S,
        )
        assert t_out.shape == (B, S) and t_out.dtype == torch.int32
        yield c, (np.asarray(j_out), np.asarray(j_end)), (t_out.numpy(), t_end.numpy())
        start = np.maximum(np.asarray(j_end), 0).astype(np.int32)


def _frames(pcm, bits, cfg, S, nframes):
    ch = pcm.shape[1]
    params = default_cookie(44100, bits, ch, S)
    enc = AlacEncoder(params, cfg)
    chunks = [pcm[i * S : (i + 1) * S] for i in range(nframes - 1)]
    chunks.append(pcm[(nframes - 1) * S : (nframes - 1) * S + S // 3 + 1])  # partial
    return [enc.encode_frame(c) for c in chunks], params


@pytest.mark.parametrize("S", [173, 256])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_scan(case, S):
    name, pcm, bits, cfg, _ = case
    payloads, params = _frames(pcm, bits, cfg, S, 4)
    fb = parse_frame_headers_vec(payloads, params)
    assert fb.words.shape[1] <= W_PAD
    fb.words = np.pad(fb.words, ((0, 0), (0, W_PAD - fb.words.shape[1])))
    for c, (jo, je), (to, te) in _channels(fb, S):
        np.testing.assert_array_equal(to, jo, err_msg=f"{name} channel {c}")
        np.testing.assert_array_equal(te, je, err_msg=f"{name} channel {c} end")


def test_plain_matches_jax_scan_full_frames():
    """Real 4096-sample frames: orders 0/1/4/8/31 with 2048- and
    1024-sample partial frames (the smoke corpus's orders file)."""
    from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_blob
    from alacnet_tpu.container import demux
    import io

    data = (pathlib.Path(__file__).parent / "fixtures" / "torch_smoke" / "orders.m4a").read_bytes()
    info = demux.parse(io.BytesIO(data))
    blob = np.frombuffer(data, np.uint8)
    fb = parse_frame_headers_blob(
        blob, info.tables.frame_file_offsets(), info.tables.frame_byte_sizes,
        info.params,
    )
    assert set(fb.order[:, 0]) >= {0, 1, 4, 8, 31}
    for c, (jo, je), (to, te) in _channels(fb, 4096):
        np.testing.assert_array_equal(to, jo, err_msg=f"channel {c}")
        np.testing.assert_array_equal(te, je, err_msg=f"channel {c} end")


def test_frozen_lanes_and_zero_length():
    """n = 0 lanes emit zeros and end where they started; S = 1 works."""
    pcm = standard_cases()[0][1]
    payloads, params = _frames(pcm, 16, None, 64, 3)
    fb = parse_frame_headers_vec(payloads, params)
    fb.n_samples[1] = 0
    for S in (1, 64):
        for c, (jo, je), (to, te) in _channels(fb, S):
            np.testing.assert_array_equal(to, jo)
            np.testing.assert_array_equal(te, je)
            assert (to[1] == 0).all()


def test_reverse_coefs_matches_jax():
    from alacnet_tpu.ops.lpc import reverse_coefs as j_reverse
    from alacnet_tpu_torch.ops.lpc import reverse_coefs as t_reverse

    rng = np.random.default_rng(5)
    coefs = rng.integers(-32768, 32768, (40, 31)).astype(np.int32)
    order = np.concatenate([np.arange(32), rng.integers(0, 32, 8)]).astype(np.int32)
    np.testing.assert_array_equal(t_reverse(coefs, order), j_reverse(coefs, order))
