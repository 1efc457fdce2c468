"""The port's encode stages (ops/encode.py, torch) against the JAX
package's (alacnet_tpu/ops/encode.py), on the CPU, exact equality.

On CPU tensors the kernel wrappers of ops/cuda/enc_stages.py run these
plain versions, so this file holds the arithmetic the ``enc_pred`` and
``enc_rice`` kernels are checked against on the card
(tests/test_torch_cuda.py).  Inputs are made with numpy from a seed and
handed to both packages; parameters cross over through
``params_from_numpy``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.ops import encode as jenc  # noqa: E402
from alacnet_tpu.ops.lpc import LpcParams as JLpcParams  # noqa: E402
from alacnet_tpu.ops.lpc import reverse_coefs  # noqa: E402
from alacnet_tpu_torch.ops import encode as tenc  # noqa: E402
from alacnet_tpu_torch.ops.cuda import enc_stages  # noqa: E402

from .test_torch_cuda import TROUBLE_CASES, trouble_inputs, trouble_params  # noqa: E402

RSS = (16, 17, 24, 25)
QUANT = (9, 15)


def _lanes(B, S, rng, rss):
    """Signals per lane: smooth, noisy near full scale for its rss,
    silence with spikes (zero runs), full-scale noise (escapes), and
    unconstrained int32 values (wraparound in every product)."""
    t = np.arange(S)[None, :]
    lane = np.arange(B)[:, None]
    lim = (1 << (rss - 1)).astype(np.int64)[:, None]
    sig = (lim // 3) * np.sin(t * 0.03 + lane) + rng.normal(0, 50, (B, S))
    kind = np.arange(B) % 5
    sig[kind == 1] = np.where(rng.random((S,)) < 0.05, 9, 0)
    sig[kind == 2] = rng.integers(-lim, lim, (B, S))[kind == 2]
    sig = np.clip(sig, -lim, lim - 1)
    wild = rng.integers(-(1 << 31), 1 << 31, (B, S), dtype=np.int64)
    sig[kind == 4] = wild[kind == 4]
    return sig.astype(np.int32)


def _params(B, order, rng, kmod=None):
    """(JAX LpcParams, JAX RiceEncParams) as numpy arrays: every lane
    pairs one rss of RSS with one quant of QUANT."""
    lane = np.arange(B)
    rss = np.array(RSS, np.int32)[lane % len(RSS)]
    quant = np.array(QUANT, np.int32)[(lane // len(RSS)) % len(QUANT)]
    coefs = np.zeros((B, 31), np.int32)
    if 0 < order < 31:
        coefs[:, :order] = rng.integers(-3000, 3000, (B, order))
    orders = np.full(B, order, np.int32)
    lp = JLpcParams(orders, quant, reverse_coefs(coefs, orders), rss)
    km = np.where(lane % 2 == 0, 14, 4) if kmod is None else np.full(B, kmod)
    km = km.astype(np.int32)
    rp = jenc.RiceEncParams(
        rss, km, np.full(B, 10, np.int32),
        np.where(lane % 3 == 0, 40, 10).astype(np.int32),
        np.where(lane % 4 == 3, -1, (1 << km) - 1).astype(np.int32),
    )
    return lp, rp


def _jax(params):
    return type(params)(*(jnp.asarray(x) for x in params))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.mark.parametrize(
    "order,max_order",
    [(0, 0), (0, 3), (1, 1), (1, 4), (6, 6), (6, 9), (8, 8), (8, 11),
     (31, 0), (31, 3)],
)
def test_predictor_errors_matches_jax(order, max_order):
    rng = np.random.default_rng(100 + order + max_order)
    B, S = 16, 96
    lp, rp = _params(B, order, rng)
    sig = _lanes(B, S, rng, lp.rss)
    n = np.full(B, S, np.int32)
    n[3], n[9], n[12] = 0, 1, 40  # frozen, single-sample, ragged
    want = jenc.predictor_errors(jnp.asarray(sig), jnp.asarray(n), _jax(lp), S,
                                 max_order=max_order)
    tlp, _ = tenc.params_from_numpy(lp, rp, "cpu")
    got = tenc.predictor_errors(torch.from_numpy(sig), torch.from_numpy(n), tlp, S,
                                max_order=max_order)
    _eq(got, want)


def _residuals(B, S, rng):
    errs = rng.integers(-40, 40, (B, S)).astype(np.int32)
    errs[rng.random((B, S)) < 0.5] = 0
    errs[1] = 0  # all-zero lane: the longest runs
    errs[2, ::7] = rng.integers(-(1 << 20), 1 << 20, errs[2, ::7].shape)  # escapes
    errs[5, 10:80] = 0
    n = np.full(B, S, np.int32)
    n[4], n[6], n[7] = 0, 1, S // 3
    return errs, n


def test_zero_run_lengths_matches_jax():
    rng = np.random.default_rng(3)
    B, S = 12, 128
    errs, n = _residuals(B, S, rng)
    want = jenc.zero_run_lengths(jnp.asarray(errs), jnp.asarray(n), S)
    _eq(tenc.zero_run_lengths(torch.from_numpy(errs), torch.from_numpy(n), S), want)


@pytest.mark.parametrize("kmod", [None, 4, 14, 7])
def test_rice_symbols_and_merge_match_jax(kmod):
    rng = np.random.default_rng(20 + (kmod or 0))
    B, S = 16, 160
    errs, n = _residuals(B, S, rng)
    _, rp = _params(B, 6, rng, kmod=kmod)
    zr = np.array(jenc.zero_run_lengths(jnp.asarray(errs), jnp.asarray(n), S))
    want = jenc.rice_symbols(jnp.asarray(errs), jnp.asarray(zr), jnp.asarray(n),
                             _jax(rp), S)
    _, trp = tenc.params_from_numpy(_params(B, 6, rng)[0], rp, "cpu")
    got = tenc.rice_symbols(torch.from_numpy(errs), torch.from_numpy(zr),
                            torch.from_numpy(n), trp, S)
    for name, g, w in zip(("vals16", "vals32", "widths", "bad"), got, want):
        _eq(g, w, name)
    assert np.asarray(want[2])[2, ::7, 0].max() == 9  # escapes were taken
    merged = jenc.merge_symbol_chunks(*want[:3])
    tmerged = tenc.merge_symbol_chunks(*got[:3])
    for name, g, w in zip(("c0", "c1", "c2", "ws"), tmerged, merged):
        w = np.asarray(w)
        _eq(g, w.view(np.int32) if w.dtype == np.uint32 else w, name)
    # the kernel wrapper's plain route: the same, plus the bit totals
    c0, c1, c2, ws, bits, bad = enc_stages.rice_merge_fused(
        torch.from_numpy(errs), torch.from_numpy(zr), torch.from_numpy(n), trp, S
    )
    assert torch.equal(ws, tmerged[3]) and torch.equal(c2, tmerged[2])
    _eq(bits, np.asarray(merged[3]).astype(np.int32).sum(1))
    _eq(bad, want[3])


@pytest.mark.parametrize("S", [160, 161])
def test_merge_pair_chunks_matches_jax(S):
    rng = np.random.default_rng(S)
    B = 8
    errs, n = _residuals(B, S, rng)
    _, rp = _params(B, 6, rng)
    zr = jenc.zero_run_lengths(jnp.asarray(errs), jnp.asarray(n), S)
    v16, v32, w, _ = jenc.rice_symbols(jnp.asarray(errs), zr, jnp.asarray(n),
                                      _jax(rp), S)
    c0, c1, c2, ws = (np.asarray(x) for x in jenc.merge_symbol_chunks(v16, v32, w))
    # A fat pair: two adjacent near-maximal samples on lane 3.
    ws = ws.copy()
    c0, c1, c2 = (x.copy() for x in (c0, c1, c2))
    ws[3, 20:22] = 81
    c0[3, 20:22] = 0x1FFFF
    c1[3, 20:22] = rng.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32)
    want = jenc.merge_pair_chunks(*(jnp.asarray(x) for x in (c0, c1, c2, ws)))
    got = tenc.merge_pair_chunks(
        *(torch.from_numpy(x.view(np.int32)) for x in (c0, c1, c2)),
        torch.from_numpy(ws),
    )
    for name, g, w_ in zip(("ph", "pm", "pl", "pws", "fat"), got, want):
        w_ = np.asarray(w_)
        _eq(g, w_.view(np.int32) if w_.dtype == np.uint32 else w_, name)
    assert got[3][3, 10] == -1 and bool(got[4][3]) and not bool(got[4][0])


@pytest.mark.parametrize(
    "bits,lw,sh,ub8,wide,order",
    [
        (16, 1, 1, 0, False, 6),
        (16, 0, 0, 0, False, 31),
        (24, 2, 1, 0, True, 4),
        (24, 200, 3, 0, True, 6),
        (24, 200, 16, 0, True, 1),
        (24, 1, 1, 8, False, 8),
        (24, 0, 0, 8, False, 0),
    ],
)
@pytest.mark.parametrize("pairs", [False, True])
def test_encode_stages_pcm_matches_jax(bits, lw, sh, ub8, wide, order, pairs):
    rng = np.random.default_rng(bits + lw + sh + ub8 + order)
    F, S = 6, 80
    lim = 1 << (bits - 1)
    pcm = rng.integers(-lim, lim, (F, S, 2)).astype(np.int32)
    pcm[1] = (np.sin(np.arange(S) * 0.05)[:, None] * (lim // 2)).astype(np.int32)
    pcm[2] = 0
    stereo = np.array([1, 1, 1, 0, 1, 0], bool)
    pcm[~stereo, :, 1] = 0
    ns_f = np.array([S, S, S, S, 33, 1], np.int32)
    ns = np.concatenate([ns_f, np.where(stereo, ns_f, 0)]).astype(np.int32)
    lp, rp = _params(2 * F, order, rng)
    rss = (bits - ub8 + np.concatenate([stereo, stereo])).astype(np.int32)
    lp = lp._replace(rss=rss)
    rp = rp._replace(rss=rss)
    mo = 0 if order in (0, 31) else order
    kw = dict(max_order=mo, lw=lw, sh=sh, ub8=ub8, wide=wide, pairs=pairs)
    want = jenc.encode_stages_pcm(
        jnp.asarray(pcm), jnp.asarray(stereo), jnp.asarray(ns), _jax(lp), _jax(rp),
        S, **kw,
    )
    tlp, trp = tenc.params_from_numpy(lp, rp, "cpu")
    got = tenc.encode_stages_pcm(
        torch.from_numpy(pcm), torch.from_numpy(stereo), torch.from_numpy(ns),
        tlp, trp, S, **kw,
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        _eq(g, w.view(np.int32) if w.dtype == np.uint32 else w)


def test_encode_stages_matches_jax_fused_interpret():
    """The port's stages against the JAX package's Pallas kernels, run
    in interpret mode as tests/test_encode_kernel.py runs them."""
    from alacnet_tpu.ops.pallas.enc_stages import encode_stages_fused

    rng = np.random.default_rng(9)
    B, S = 8, 64
    lp, rp = _params(B, 6, rng)
    sig = _lanes(B, S, rng, lp.rss)
    # Lanes within their sample width only: on a lane whose emitter
    # desyncs (``bad``, which the encoder raises on) the JAX package's
    # two paths sum different bit totals.
    sig[4] = sig[0]
    n = np.full(B, S, np.int32)
    n[2], n[5] = 0, 17
    want = encode_stages_fused(jnp.asarray(sig), jnp.asarray(n), _jax(lp), _jax(rp),
                               S, max_order=6, interpret=True)
    tlp, trp = tenc.params_from_numpy(lp, rp, "cpu")
    got = tenc.encode_stages(torch.from_numpy(sig), torch.from_numpy(n), tlp, trp, S,
                             max_order=6)
    for name, g, w in zip(("c0", "c1", "c2", "ws", "bits", "bad"), got, want):
        w = np.asarray(w)
        _eq(g, w.view(np.int32) if w.dtype == np.uint32 else w, name)
    assert not got[5].any()


@pytest.mark.parametrize("case", TROUBLE_CASES)
def test_trouble_points_match_jax(case):
    """The plain stages against the JAX package's on inputs that reach
    each place the kernels' C++ arithmetic could part from jax.lax's
    (tests/test_torch_cuda.py holds the kernels to the same inputs)."""
    d = trouble_inputs(case)
    B, S = d["sig"].shape
    jlp = JLpcParams(d["order"], d["quant"], reverse_coefs(d["coefs"], d["order"]), d["rss"])
    jrp = jenc.RiceEncParams(d["rss"], d["kmod"], d["ihist"], d["mult"], d["kmask"])
    tlp, trp = trouble_params(d, "cpu")
    sig, n = torch.from_numpy(d["sig"]), torch.from_numpy(d["n"])
    want = jenc.predictor_errors(jnp.asarray(d["sig"]), jnp.asarray(d["n"]), _jax(jlp), S,
                                 max_order=d["max_order"])
    got = enc_stages.predictor_errors_fused(sig, n, tlp, S, max_order=d["max_order"])
    _eq(got, want, "errs")
    errs = np.array(want) if d["errs"] is None else d["errs"]
    zr = np.array(jenc.zero_run_lengths(jnp.asarray(errs), jnp.asarray(d["n"]), S))
    _eq(tenc.zero_run_lengths(torch.from_numpy(errs), n, S), zr, "zruns")
    jsym = jenc.rice_symbols(jnp.asarray(errs), jnp.asarray(zr), jnp.asarray(d["n"]),
                             _jax(jrp), S)
    tsym = tenc.rice_symbols(torch.from_numpy(errs), torch.from_numpy(zr), n, trp, S)
    for name, g, w in zip(("vals16", "vals32", "widths", "bad"), tsym, jsym):
        _eq(g, w, name)
    merged = [np.asarray(x) for x in jenc.merge_symbol_chunks(*jsym[:3])]
    c0, c1, c2, ws, bits, bad = enc_stages.rice_merge_fused(
        torch.from_numpy(errs), torch.from_numpy(zr), n, trp, S
    )
    for name, g, w in zip(("c0", "c1", "c2", "ws"), (c0, c1, c2, ws), merged):
        _eq(g, w.view(np.int32) if w.dtype == np.uint32 else w, name)
    widths = np.asarray(jsym[2]).astype(np.int32)
    # Each case reaches its trouble point.
    if case == "int32_wraparound":
        assert bad.any() and not bad.all()  # INT32_MIN lanes desync
    elif case == "shift_counts":
        assert (widths[:, :, 1] >= 32).any()  # 32- and 33-bit escapes
    elif case == "clz_zero":
        # a zero history gives kz = clz(0) + 0 - 24 = 16 (15 for a zero
        # remainder); clz(0) = 32 would give 8
        assert (widths[:, :, 3] >= 15).any()
    elif case == "uint32_patterns":
        assert (c1 < 0).any() and (c2 < 0).any()
    elif case == "mono_ragged":
        live = np.arange(S)[None, :] < d["n"][:, None]
        assert not widths[~live].any() and not bits[d["n"] == 0].any()
        assert live.any(axis=1).sum() < B
