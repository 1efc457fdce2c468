"""The ``rice_emit`` route of the port against the JAX package, on the
CPU, exact equality.

On CPU tensors ``ops/cuda/rice_emit.rice_symbols_fused`` runs its plain
version (``ops/encode.rice_symbols``), so this file holds the arithmetic
that the ``rice_emit`` kernel is checked against on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 6); then the route as a
whole: symbol planes -> the native symbol packer -> the payloads the
production encoder writes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from alacnet_tpu import native as jnative  # noqa: E402
from alacnet_tpu.ops import encode as jenc  # noqa: E402
from alacnet_tpu_torch import native as tnative  # noqa: E402
from alacnet_tpu_torch.codec import encoder_device  # noqa: E402
from alacnet_tpu_torch.codec.cookie import default_cookie  # noqa: E402
from alacnet_tpu_torch.codec.encoder import EncoderConfig  # noqa: E402
from alacnet_tpu_torch.ops import encode as tenc  # noqa: E402
from alacnet_tpu_torch.ops.cuda.rice_emit import rice_symbols_fused  # noqa: E402

from .test_encoder_tpu import CASES, S, _signal  # noqa: E402
from .test_torch_cuda import TROUBLE_CASES, trouble_inputs  # noqa: E402

FIELDS = ("vals16", "vals32", "widths", "bad")


def _residuals(B, S, rng):
    """Residual lanes: small values, zero runs (an all-zero lane and a
    long run), escapes (values far past any k), and wild int32s."""
    errs = rng.integers(-60, 60, (B, S)).astype(np.int32)
    errs[rng.random((B, S)) < 0.4] = 0
    errs[1] = 0
    errs[2, ::5] = rng.integers(-(1 << 22), 1 << 22, errs[2, ::5].shape)
    errs[3, 7:90] = 0
    errs[B - 1] = rng.integers(-(1 << 31), 1 << 31, S, dtype=np.int64)
    n = np.full(B, S, np.int32)
    n[4], n[5], n[6], n[7] = 0, 1, S // 3, S - 1  # n = 0 and partial lanes
    return errs, n


def _rice_params(B, kmod, mult, kmask_kind):
    lane = np.arange(B)
    rss = np.array([16, 17, 24, 25], np.int32)[lane % 4]
    km = np.full(B, kmod, np.int32)
    kmask = {
        "full": (1 << km) - 1,
        "all": np.full(B, -1),
        "mixed": np.where(lane % 3 == 0, -1, np.where(lane % 3 == 1, 0xFF, (1 << km) - 1)),
    }[kmask_kind]
    return jenc.RiceEncParams(
        rss, km, np.full(B, 10, np.int32), np.full(B, mult, np.int32),
        np.asarray(kmask, np.int32),
    )


def _both(errs, zr, n, rp, S):
    """(JAX rice_symbols, the port's rice_symbols_fused on CPU tensors)."""
    want = jenc.rice_symbols(
        jnp.asarray(errs), jnp.asarray(zr), jnp.asarray(n),
        type(rp)(*(jnp.asarray(x) for x in rp)), S,
    )
    trp = tenc.RiceEncParams(*(torch.from_numpy(np.asarray(x, np.int32)) for x in rp))
    got = rice_symbols_fused(
        torch.from_numpy(errs), torch.from_numpy(zr), torch.from_numpy(n), trp, S
    )
    return want, got


@pytest.mark.parametrize("kmod,mult", [(14, 40), (4, 2), (14, 2), (4, 40)])
@pytest.mark.parametrize("kmask_kind", ["full", "all", "mixed"])
def test_rice_symbols_fused_matches_jax(kmod, mult, kmask_kind):
    rng = np.random.default_rng(kmod * 100 + mult + len(kmask_kind))
    B, S = 13, 203  # multiples of neither 1024 lanes nor 256 samples
    errs, n = _residuals(B, S, rng)
    zr = np.array(jenc.zero_run_lengths(jnp.asarray(errs), jnp.asarray(n), S))
    rp = _rice_params(B, kmod, mult, kmask_kind)
    want, got = _both(errs, zr, n, rp, S)
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    widths = got[2].numpy()
    assert (widths[:, :, 0] == 9).any()  # escapes were taken
    assert (widths[:, :, 2] > 0).any()  # zero-run symbols were emitted
    live = np.arange(S)[None, :] < n[:, None]
    assert not widths[~live].any()  # nothing past n, nothing on n = 0 lanes


@pytest.mark.parametrize("case", TROUBLE_CASES)
def test_rice_symbols_fused_trouble_points_match_jax(case):
    """The encoder's trouble-point inputs (int32 wrap, shift counts,
    clz(0), uint32 patterns, ragged and n = 0 lanes) through the route."""
    d = trouble_inputs(case)
    B, S = d["sig"].shape
    errs = d["errs"]
    if errs is None:
        errs = (d["sig"] // 7).astype(np.int32)
    zr = np.array(jenc.zero_run_lengths(jnp.asarray(errs), jnp.asarray(d["n"]), S))
    rp = jenc.RiceEncParams(d["rss"], d["kmod"], d["ihist"], d["mult"], d["kmask"])
    want, got = _both(errs, zr, d["n"], rp, S)
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("seed", range(3))
def test_rice_symbols_values_past_n_and_at_width_0_match_jax(seed):
    """Every plane element is defined, not only the live fields: past a
    lane's n the state holds and the symbols are still computed from the
    sample's residual and zero run, and a field whose width is 0 keeps
    its value.  The rice_emit kernel writes all of them (the card tests
    compare every element), so the plain version is held against JAX on
    exactly those elements, which are not all zero."""
    rng = np.random.default_rng(40 + seed)
    B, S = 24, 256
    errs, n = _residuals(B, S, rng)
    n[8:13] = [0, 3, S + 50, 100, -4]  # n = 0, short, past S, partial, < 0
    zr = np.array(jenc.zero_run_lengths(jnp.asarray(errs), jnp.asarray(n), S))
    rp = _rice_params(B, 14, 40, "mixed")
    want, got = _both(errs, zr, n, rp, S)
    v16, v32, widths = (g.numpy() for g in got[:3])
    w16, w32 = np.asarray(want[0]), np.asarray(want[1])
    past = np.arange(S)[None, :] >= n[:, None]
    assert past.sum() > 0 and not widths[past].any()
    for name, g, w in (("vals16", v16, w16), ("vals32", v32, w32)):
        np.testing.assert_array_equal(g[past], w[past], err_msg=name)
        assert g[past].any(), name
    # fields of width 0 inside n: v0/v1 where the value symbol is not
    # live (a skipped zero run), v2/v3 where no zero-run symbol follows
    for field, (g, w, k) in enumerate(((v16, w16, 0), (v32, w32, 0), (v16, w16, 1),
                                       (v32, w32, 1))):
        idle = ~past & (widths[:, :, field] == 0)
        np.testing.assert_array_equal(g[:, :, k][idle], w[:, :, k][idle], err_msg=str(field))
    assert (~past & (widths[:, :, 2] == 0) & (v16[:, :, 1] != 0)).any()


def test_rice_symbols_fused_empty_shapes():
    rp = tenc.RiceEncParams(*(torch.full((3,), v, dtype=torch.int32)
                              for v in (16, 14, 10, 40, (1 << 14) - 1)))
    z = torch.zeros((3, 0), dtype=torch.int32)
    v16, v32, w, bad = rice_symbols_fused(z, z, torch.zeros(3, dtype=torch.int32), rp, 0)
    assert v16.shape == (3, 0, 2) and v32.shape == (3, 0, 2) and w.shape == (3, 0, 4)
    assert not bad.any()


def _random_planes(rng):
    """The random planes of tests/test_encoder_native.py's symbol-packer
    test: small widths (the folded fast path), rows forced wide (the
    field-by-field fallback), zero widths, ragged header fields."""
    F, S = 5, 96
    stereo = np.array([1, 0, 1, 1, 0], np.uint8)
    n = np.array([96, 41, 96, 7, 1], np.int32)
    B = 2 * F
    wid = rng.integers(0, 12, size=(B, S, 4)).astype(np.int8)
    wide_rows = rng.random(size=(B, S)) < 0.08
    wid[wide_rows] = np.array([16, 32, 9, 30], np.int8)
    wid[rng.random(size=(B, S, 4)) < 0.2] = 0
    v16 = rng.integers(0, 1 << 16, size=(B, S, 2)).astype(np.uint16)
    v32 = rng.integers(0, 1 << 32, size=(B, S, 2), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(1, 9, size=F)
    h_off = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    hv = rng.integers(0, 1 << 20, size=int(h_off[-1]), dtype=np.int64).astype(np.uint32)
    hw = rng.integers(1, 24, size=int(h_off[-1])).astype(np.uint8)
    return hv, hw, h_off, v16, v32, wid, n, stereo


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_symbol_frames_native_matches_jax(seed):
    if not tnative.available():
        pytest.skip("the native host tier did not build")
    args = _random_planes(np.random.default_rng(seed))
    got = tnative.pack_symbol_frames_native(*args, out_stride=4096)
    want = jnative.pack_symbol_frames_native(*args, out_stride=4096)
    np.testing.assert_array_equal(got[1], want[1])
    for f, end in enumerate(want[1]):
        nb = -(-int(end) // 8)
        assert got[0][f, :nb].tobytes() == want[0][f, :nb].tobytes()


SYMBOL_CASES = [c for c in CASES if c[3].uncompressed_bytes == 0]


@pytest.mark.parametrize(
    "name,bits,ch,cfg,kind", SYMBOL_CASES, ids=[c[0] for c in SYMBOL_CASES]
)
def test_symbol_route_matches_encoder_payloads(name, bits, ch, cfg, kind, monkeypatch):
    """The chunk's Rice-stage inputs -> rice_symbols_fused -> the symbol
    packer with the chunk's header arrays gives the payloads that
    ``encode_frames_device(device="cpu")`` writes (pair planes, pair
    packer)."""
    if not tnative.available():
        pytest.skip("the native host tier did not build")
    from alacnet_tpu_torch.ops.cuda import enc_stages

    rng = np.random.default_rng(0)
    params = default_cookie(44100, bits, ch, max_samples_per_frame=S)
    pcm = _signal(kind, bits, ch, rng)
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    calls, packs = [], []
    rice = enc_stages.rice_merge_fused
    pack = encoder_device._pack

    def rec_rice(*args, **kwargs):
        calls.append((args, kwargs))
        return rice(*args, **kwargs)

    def rec_pack(prep, fetch, timings):
        payloads = pack(prep, fetch, timings)
        packs.append((prep, payloads))
        return payloads

    monkeypatch.setattr(enc_stages, "rice_merge_fused", rec_rice)
    monkeypatch.setattr(encoder_device, "_pack", rec_pack)
    cfg = EncoderConfig(**{**cfg.__dict__})
    payloads = encoder_device.encode_frames_device(frames, params, cfg, device="cpu")
    assert len(calls) == len(packs) == 1
    (args, kwargs), (prep, chunk_payloads) = calls[0], packs[0]
    assert chunk_payloads == payloads
    v16, v32, widths, bad = rice_symbols_fused(*args, **kwargs)
    assert not bad.any()
    got = encoder_device.pack_symbol_planes(prep, v16.numpy(), v32.numpy(), widths.numpy())
    assert got == payloads
