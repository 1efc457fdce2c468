"""Kernel 11's plain version, the encoder's prologue, on the CPU.

``encode_prologue_plain`` (the CPU route of ``encode_prologue_fused``,
and what the ``enc_prologue`` kernel is held to on the card in
tests/test_torch_cuda.py) through ``encode_stages_pcm`` against the JAX
package's ``encode_stages_pcm`` on narrow content, and on its own
against the host encoder's arithmetic (int64, then the low 32 bits),
which the port follows where the JAX package's split product differs
(``wide`` with shifts past 16).  Exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import alacnet_tpu_torch as at  # noqa: E402
from alacnet_tpu.ops import encode as jenc  # noqa: E402
from alacnet_tpu_torch.codec import encoder_device as ed  # noqa: E402
from alacnet_tpu_torch.codec.cookie import default_cookie  # noqa: E402
from alacnet_tpu_torch.ops import encode as tenc  # noqa: E402
from alacnet_tpu_torch.ops.cuda import enc_prologue as tep  # noqa: E402

from .test_torch_cuda import prologue_case  # noqa: E402
from .test_torch_encode_ops import _eq, _jax, _params  # noqa: E402


def host_fold(pcm, stereo, lw, sh, ub8):
    """The host encoder's prologue (codec/encoder.py ``encode_frame``):
    the strip and the decorrelation in int64, the fold, then each value's
    low 32 bits as int32.  Shift counts past 63 fill with the sign, as
    torch's do."""
    x = pcm.astype(np.int64) >> ub8
    left, right = x[:, :, 0], x[:, :, 1]
    if lw:
        cb = left - right
        ca = right + ((cb * lw) >> min(sh, 63))
    else:
        ca, cb = left, right
    st = stereo[:, None]
    sig = np.concatenate([np.where(st, ca, left), np.where(st, cb, 0)])
    return sig.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("lw,sh", [(0, 0), (1, 1), (3, 4)])
@pytest.mark.parametrize("ub8", [0, 8])
def test_encode_stages_pcm_matches_jax(lw, sh, ub8):
    """Every output of ``encode_stages_pcm`` (its prologue on the plain
    route) against the JAX package's: mixed stereo and mono frames,
    ragged counts, narrow content (16 bits after the strip)."""
    F, S = 7, 72
    bits = 16 + ub8
    pcm, stereo = prologue_case(F, S, bits, lw + sh + ub8)
    rng = np.random.default_rng(lw + 3 * sh + ub8)
    ns_f = np.full(F, S, np.int32)
    ns_f[2], ns_f[5] = 33, 1
    ns = np.concatenate([ns_f, np.where(stereo, ns_f, 0)]).astype(np.int32)
    lp, rp = _params(2 * F, 6, rng)
    rss = (16 + np.concatenate([stereo, stereo])).astype(np.int32)
    lp, rp = lp._replace(rss=rss), rp._replace(rss=rss)
    kw = dict(max_order=6, lw=lw, sh=sh, ub8=ub8, wide=False)
    want = jenc.encode_stages_pcm(
        jnp.asarray(pcm), jnp.asarray(stereo), jnp.asarray(ns), _jax(lp), _jax(rp), S, **kw,
    )
    tlp, trp = tenc.params_from_numpy(lp, rp, "cpu")
    got = tenc.encode_stages_pcm(
        torch.from_numpy(pcm), torch.from_numpy(stereo), torch.from_numpy(ns),
        tlp, trp, S, **kw,
    )
    assert len(got) == len(want)
    for name, g, w in zip(("c0", "c1", "c2", "ws", "bits", "bad"), got, want):
        w = np.asarray(w)
        _eq(g, w.view(np.int32) if w.dtype == np.uint32 else w, name)


@pytest.mark.parametrize("sh", [*range(32), 40, 64, 200])
@pytest.mark.parametrize("wide", [False, True])
def test_prologue_plain_matches_host_arithmetic(sh, wide):
    """Every shift, with ``|cb| * lw`` past 2**31 on wide content (the
    JAX package's split product drops a carry there for shifts past 16;
    the port follows the host)."""
    bits = 24 if wide else 16
    pcm, stereo = prologue_case(9, 40, bits, sh)
    for lw in (1, 255):
        got = tep.encode_prologue_plain(torch.from_numpy(pcm), torch.from_numpy(stereo),
                                        lw, sh, 0, wide)
        _eq(got, host_fold(pcm, stereo, lw, sh, 0), f"lw={lw}")


@pytest.mark.parametrize("ub8", [0, 8, 16])
def test_prologue_plain_strips_extra_bits_like_the_host(ub8):
    pcm, stereo = prologue_case(6, 50, 24, ub8)
    for lw, sh in ((0, 0), (1, 1), (7, 3)):
        got = tep.encode_prologue_plain(torch.from_numpy(pcm), torch.from_numpy(stereo),
                                        lw, sh, ub8, ub8 == 0)
        _eq(got, host_fold(pcm, stereo, lw, sh, ub8), f"lw={lw} sh={sh}")


@pytest.mark.parametrize("sh", [17, 24, 31])
def test_wide_shifts_past_16_encode_like_the_host(sh):
    """The device encoder on the CPU (the plain prologue) writes the host
    encoder's bytes for 24-bit stereo with large products."""
    S = 256
    params = default_cookie(44100, 24, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=4, interlacing_shift=sh, interlacing_leftweight=255)
    pcm, _ = prologue_case(2 * S, 1, 24, sh, mono_share=0.0)
    pcm = pcm.reshape(2 * S, 2)
    frames = [pcm[:S], pcm[S:]]
    host = at.AlacEncoder(params, cfg)
    assert ed.encode_frames_device(frames, params, cfg, device="cpu") == [
        host.encode_frame(f) for f in frames]


def test_prologue_routes_and_shapes_on_cpu():
    """On CPU tensors the wrapper returns the plain signal's (S, 2F)
    transposed view (``auto`` and ``torch``), so ``encode_stages_pcm``
    hands the predictor the plain (2F, S) tensor itself; ``cuda`` and an
    unknown route raise."""
    pcm, stereo = prologue_case(5, 33, 16, 1)
    p, s = torch.from_numpy(pcm), torch.from_numpy(stereo)
    want = tep.encode_prologue_plain(p, s, 1, 1)
    assert want.shape == (10, 33) and want.dtype == torch.int32 and want.is_contiguous()
    for kernel in ("auto", "torch"):
        got = tep.encode_prologue_fused(p, s, 1, 1, kernel=kernel)
        assert got.shape == (33, 10) and torch.equal(got.t(), want)
        assert got.t().is_contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        tep.encode_prologue_fused(p, s, 1, 1, kernel="cuda")
    with pytest.raises(ValueError, match="kernel must be"):
        tep.encode_prologue_fused(p, s, 1, 1, kernel="fused")
