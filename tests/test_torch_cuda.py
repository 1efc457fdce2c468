"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and ``nvcc``; without a card each
skips with the reason.  On the card, whose machine has no JAX (which
``tests/conftest.py`` imports): ``python -m pytest
tests/test_torch_cuda.py --noconftest -o addopts= -q``.  Exact equality.
"""

import io
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

SMOKE = pathlib.Path(__file__).parent / "fixtures" / "torch_smoke"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    from alacnet_tpu_torch.ops.cuda import _lib

    _lib.get_lib()  # builds the kernels; a failed build fails the test
    return torch.device("cuda")


def _span(dev, name="music.m4a", copies=4):
    """The first planned span of a smoke file, as the main path builds it."""
    from alacnet_tpu_torch.batch import _collect
    from alacnet_tpu_torch.ops.cuda.pack_rows import blob_words
    from alacnet_tpu_torch.parallel import pipeline as P

    info, blob = _collect(io.BytesIO((SMOKE / name).read_bytes()))
    blob = np.concatenate([blob] * copies)
    off1 = info.tables.frame_file_offsets()
    offs = np.concatenate([off1 + i * (len(blob) // copies) for i in range(copies)])
    szs = np.tile(info.tables.frame_byte_sizes, copies)
    perm, _, spans, span_batch = P.plan_blob_batches(
        blob, offs, szs, info.params, 4096, True
    )
    fb, ow, nb, W = span_batch(perm[spans[0][0] : spans[0][1]], device_rows=True)
    fb = P.pad_frame_batch(fb)
    bw = blob_words(blob, dev, max_w=W + 8)
    ow = torch.from_numpy(P._pad_axis0(ow, fb.batch)).to(dev)
    nb = torch.from_numpy(P._pad_axis0(nb, fb.batch)).to(dev)
    return fb, bw, ow, nb, W


def test_pack_rows_kernel_matches_plain(cuda):
    from alacnet_tpu_torch.ops.cuda.pack_rows import pack_rows

    _, bw, ow, nb, W = _span(cuda)
    got = pack_rows(bw, ow, nb, W, kernel="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, pack_rows(bw, ow, nb, W, kernel="torch"))


@pytest.mark.parametrize("name", ["music.m4a", "orders.m4a", "spiky.m4a", "mono16.m4a"])
def test_rice_lpc_kernel_matches_plain(cuda, name):
    from alacnet_tpu_torch.ops.cuda.pack_rows import pack_rows
    from alacnet_tpu_torch.ops.cuda.rice_lpc import fused_rice_lpc
    from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays

    fb, bw, ow, nb, W = _span(cuda, name, copies=1)
    words = pack_rows(bw, ow, nb, W)
    m = FrameMetaArrays.from_packed(FrameMetaArrays.pack_host(fb), cuda)
    n = torch.clamp(m.n_samples, 0, 4096)
    args = (words, m.entropy_pos, n, m.rss, m.kmod, m.init_history,
            m.rice_mult[:, 0], m.kmask, m.order[:, 0], m.quant[:, 0],
            m.rc[:, 0].contiguous(), 4096)
    out, end = fused_rice_lpc(*args, kernel="cuda")
    torch.cuda.synchronize()
    p_out, p_end = fused_rice_lpc(*args, kernel="torch")
    assert torch.equal(out, p_out) and torch.equal(end, p_end)


def test_bulk_bits_kernel_matches_plain(cuda):
    from alacnet_tpu_torch.ops.cuda.bulk_bits import bulk_bits
    from alacnet_tpu_torch.ops.cuda.pack_rows import pack_rows
    from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays

    fb, bw, ow, nb, W = _span(cuda, "hires24.m4a")
    words = pack_rows(bw, ow, nb, W)
    m = FrameMetaArrays.from_packed(FrameMetaArrays.pack_host(fb), cuda)
    ub8 = m.ub * 8
    args = (words, m.payload_pos, torch.clamp(m.n_samples, 0, 4096), ub8,
            torch.where(m.is_stereo, ub8, 0), 4096)
    got = bulk_bits(*args, kernel="cuda")
    torch.cuda.synchronize()
    want = bulk_bits(*args, kernel="torch")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_decode_streams_on_card_matches_expected(cuda):
    import hashlib

    import alacnet_tpu_torch
    from alacnet_tpu_torch.ops.cuda import _lib

    expected = json.loads((SMOKE / "expected.json").read_text())
    names = sorted(expected)
    _lib.reset_launches()
    got = alacnet_tpu_torch.decode_streams(
        [io.BytesIO((SMOKE / n).read_bytes()) for n in names], device="cuda"
    )
    for name, r in zip(names, got):
        assert hashlib.sha256(r.pcm.tobytes()).hexdigest() == expected[name]["sha256"]
    assert all(_lib.LAUNCHES[k] > 0 for k in ("pack_rows", "rice_lpc", "bulk_bits"))


# ---------------------------------------------------------------------------
# Encoder kernels: enc_pred and enc_rice against their plain versions.
# ---------------------------------------------------------------------------

ENC_ORDERS = [0, 1, 6, 8, 31]


def _enc_inputs(B, S, order, dev, seed=0):
    """A lane batch that reaches every branch of both automatons: music,
    silence with isolated spikes (zero runs), full-scale noise (escapes),
    unconstrained int32 values, ragged and zero ``n`` (mono channel-B
    lanes), rss 16/17/24/25 and quant 9/15."""
    from alacnet_tpu_torch.ops.encode import RiceEncParams
    from alacnet_tpu_torch.ops.lpc import LpcParams, reverse_coefs

    rng = np.random.default_rng(seed + 7 * B + S + order)
    lane = np.arange(B)
    rss = np.array([16, 17, 24, 25], np.int32)[lane % 4]
    quant = np.where(lane % 3 == 0, 15, 9).astype(np.int32)
    t = np.arange(S)[None, :]
    amp = (1 << (rss - 2))[:, None].astype(np.float64)
    sig = amp * np.sin(t * 0.02 + lane[:, None]) + rng.normal(0, 40, (B, S))
    kind = lane % 5
    sig[kind == 1] = 0
    spikes = rng.random((B, S)) < 0.01
    sig[kind == 1] = np.where(spikes[kind == 1], 5, 0)
    lim = (1 << (rss - 1))[:, None]
    noise = rng.integers(-lim, lim, (B, S))
    sig[kind == 2] = noise[kind == 2]
    sig = np.clip(sig, -lim, lim - 1).astype(np.int32)
    # Unconstrained int32 values: every product wraps, and the emitter
    # desyncs (``bad``); kernel and plain version must still agree.
    wild = rng.integers(-(1 << 31), 1 << 31, (B, S), dtype=np.int64)
    sig[lane % 11 == 10] = wild[lane % 11 == 10]
    n = np.full(B, S, np.int32)
    n[kind == 3] = rng.integers(0, S + 1, int((kind == 3).sum()))
    n[lane % 7 == 4] = 0
    coefs = np.zeros((B, 31), np.int32)
    if 0 < order < 31:
        coefs[:, :order] = rng.integers(-2000, 2000, (B, order))
    orders = np.full(B, order, np.int32)
    kmod = np.where(lane % 2 == 0, 14, 4).astype(np.int32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
    lp = LpcParams(T(orders), T(quant), T(reverse_coefs(coefs, orders)), T(rss))
    rp = RiceEncParams(T(rss), T(kmod), T(np.full(B, 10)),
                       T(np.where(lane % 2 == 0, 40, 10)), T((1 << kmod) - 1))
    return T(sig), T(n), lp, rp


def _max_order(order):
    return 0 if order in (0, 31) else order


#: Where the encoder's arithmetic is likely to go wrong.  Each case
#: builds stage inputs that reach one of them: tests/test_torch_encode_ops.py
#: holds the plain versions against the JAX package on them, this file
#: the kernels against the plain versions.  (The wide decorrelation
#: product is a prologue in torch, not a kernel input:
#: test_encode_stages_pcm_matches_jax covers it.)
TROUBLE_CASES = (
    "int32_wraparound",  # FIR products and sums, 2*err, h*mult, dv*mult
    "shift_counts",  # quant 0 and >= 32, rss 1/32/33 (widths of 32+)
    "clz_zero",  # silence from a zero history: clz(0) = 40
    "uint32_patterns",  # escape-dense chunks with their top bits set
    "mono_ragged",  # n = 0 channel-B lanes and ragged partial frames
)


def trouble_inputs(case, B=24, S=160, seed=0):
    """NumPy int32 stage inputs for one of TROUBLE_CASES: a dict of sig
    (B, S), n (B,), order, quant, rss (B,), coefs (B, 31), kmod, ihist,
    mult, kmask (B,), max_order, and errs (B, S) for the Rice stage, or
    None to feed it the predictor's residuals."""
    rng = np.random.default_rng(seed + 17 * TROUBLE_CASES.index(case))
    lane = np.arange(B)
    t = np.arange(S)[None, :]
    order = 8
    sig = 3000 * np.sin(t * 0.05 + lane[:, None]) + rng.normal(0, 30, (B, S))
    d = dict(
        n=np.full(B, S), quant=np.where(lane % 2, 9, 15), rss=np.full(B, 17),
        coefs=rng.integers(-3000, 3000, (B, 31)), kmod=np.full(B, 14),
        ihist=np.full(B, 10), mult=np.full(B, 40), kmask=np.full(B, (1 << 14) - 1),
    )
    errs = None
    if case == "int32_wraparound":
        sig = rng.integers(-(1 << 31), 1 << 31, (B, S))
        d["coefs"] = rng.integers(-(1 << 15), 1 << 15, (B, 31))
        d["rss"] = np.full(B, 32)
        # Lanes of huge residuals (2*err wraps; INT32_MIN desyncs) and
        # lanes of small ones under a huge multiplier (h*mult, dv*mult).
        errs = rng.integers(-(1 << 31), 1 << 31, (B, S))
        errs[:, ::9] = -(1 << 31)
        errs[:, 4::9] = (1 << 31) - 1
        small = lane % 2 == 1
        errs[small] = rng.integers(-40000, 40000, (int(small.sum()), S))
        d["mult"] = np.where(small, 1 << 17, 40)
    elif case == "shift_counts":
        d["quant"] = np.array([0, 1, 15, 31, 32, 40])[lane % 6]
        d["rss"] = np.array([1, 16, 31, 32, 33])[lane % 5]
        d["kmod"] = np.array([0, 4, 14, 31])[lane % 4]
        d["kmask"] = np.where(lane % 3 == 0, -1, np.where(lane % 3 == 1, 0, 0xFFFF))
        sig = np.where(lane[:, None] % 2, sig, rng.integers(-(1 << 30), 1 << 30, (B, S)))
    elif case == "clz_zero":
        sig = np.where(rng.random((B, S)) < 0.02, rng.integers(-9, 9, (B, S)), 0)
        sig[lane % 2 == 0] = 0
        d["ihist"] = np.zeros(B)
    elif case == "uint32_patterns":
        # Even lanes: 24-bit escapes fill bit 31 of c2.  Odd lanes: one
        # 32-bit escape and an escaped zero run in the same sample, a
        # 66-bit chunk whose unary marker fills bit 31 of c1.
        odd = lane % 2 == 1
        d["rss"] = np.where(odd, 32, 24)
        d["mult"] = np.where(odd, 1, 40)
        errs = rng.integers(-(1 << 23), 1 << 23, (B, S))
        errs[odd] = 0
        errs[odd, 0] = 5
    elif case == "mono_ragged":
        n = rng.integers(1, S + 1, B)
        n[lane % 3 == 0] = 0
        n[1] = 1
        d["n"] = n
    d = {k: np.ascontiguousarray(v, np.int32) for k, v in d.items()}
    d["order"] = np.full(B, order, np.int32)
    d["sig"] = np.asarray(sig, np.int64).astype(np.int32)
    d["errs"] = None if errs is None else errs.astype(np.int32)
    d["max_order"] = order
    return d


def trouble_params(d, device):
    """The port's (LpcParams, RiceEncParams) for trouble_inputs(...)."""
    from alacnet_tpu_torch.ops.encode import RiceEncParams
    from alacnet_tpu_torch.ops.lpc import LpcParams, reverse_coefs

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    lp = LpcParams(T(d["order"]), T(d["quant"]), T(reverse_coefs(d["coefs"], d["order"])),
                   T(d["rss"]))
    rp = RiceEncParams(T(d["rss"]), T(d["kmod"]), T(d["ihist"]), T(d["mult"]),
                       T(d["kmask"]))
    return lp, rp


@pytest.mark.parametrize("case", TROUBLE_CASES)
def test_enc_kernels_trouble_points(cuda, case):
    from alacnet_tpu_torch.ops.cuda.enc_stages import (
        predictor_errors_fused, rice_merge_fused,
    )
    from alacnet_tpu_torch.ops.encode import zero_run_lengths

    d = trouble_inputs(case)
    lp, rp = trouble_params(d, cuda)
    sig, n = (torch.from_numpy(d[k]).to(cuda) for k in ("sig", "n"))
    S = sig.shape[1]
    errs = predictor_errors_fused(sig, n, lp, S, max_order=d["max_order"], kernel="cuda")
    torch.cuda.synchronize()
    want = predictor_errors_fused(sig, n, lp, S, max_order=d["max_order"], kernel="torch")
    assert torch.equal(errs, want)
    if d["errs"] is not None:
        want = torch.from_numpy(d["errs"]).to(cuda)
    zr = zero_run_lengths(want, n, S)
    got = rice_merge_fused(want, zr, n, rp, S, kernel="cuda")
    torch.cuda.synchronize()
    ref = rice_merge_fused(want, zr, n, rp, S, kernel="torch")
    for name, g, w in zip(("c0", "c1", "c2", "ws", "bits", "bad"), got, ref):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("order", ENC_ORDERS)
@pytest.mark.parametrize("B,S", [(1, 1), (33, 255), (2048, 4096), (1, 4096), (2048, 1), (33, 4096)])
def test_enc_kernels_match_plain(cuda, B, S, order):
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.cuda.enc_stages import (
        predictor_errors_fused, rice_merge_fused,
    )
    from alacnet_tpu_torch.ops.encode import zero_run_lengths

    sig, n, lp, rp = _enc_inputs(B, S, order, cuda)
    mo = _max_order(order)
    before = dict(_lib.LAUNCHES)
    errs = predictor_errors_fused(sig, n, lp, S, max_order=mo, kernel="cuda")
    torch.cuda.synchronize()
    want = predictor_errors_fused(sig, n, lp, S, max_order=mo, kernel="torch")
    assert torch.equal(errs, want)
    # max_order above the order gives the same residuals.
    if 0 < order < 31:
        wider = predictor_errors_fused(sig, n, lp, S, max_order=31, kernel="cuda")
        assert torch.equal(wider, want)
    zr = zero_run_lengths(want, n, S)
    got = rice_merge_fused(errs, zr, n, rp, S, kernel="cuda")
    torch.cuda.synchronize()
    ref = rice_merge_fused(want, zr, n, rp, S, kernel="torch")
    for name, g, w in zip(("c0", "c1", "c2", "ws", "bits", "bad"), got, ref):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert _lib.LAUNCHES["enc_pred"] > before.get("enc_pred", 0)
    assert _lib.LAUNCHES["enc_rice"] > before.get("enc_rice", 0)


def test_encode_files_on_card_matches_expected(cuda):
    import hashlib

    import alacnet_tpu_torch
    from alacnet_tpu_torch.ops.cuda import _lib

    expected = json.loads((SMOKE / "encode_expected.json").read_text())
    decoded = {}
    for key in expected:
        name = key.split("|")[0]
        if name not in decoded:
            decoded[name] = alacnet_tpu_torch.decode_file(SMOKE / name, device="cuda")
    _lib.reset_launches()
    for key, want in expected.items():
        name, cfg_name = key.split("|")
        r = decoded[name]
        cfg = alacnet_tpu_torch.EncoderConfig(
            uncompressed_bytes=1 if cfg_name == "ub1" else 0
        )
        out = io.BytesIO()
        alacnet_tpu_torch.encode_files(
            [r.pcm], [out], r.sample_rate, r.bits_per_sample, config=cfg,
            device="cuda",
        )
        data = out.getvalue()
        assert len(data) == want["bytes"], key
        assert hashlib.sha256(data).hexdigest() == want["sha256"], key
    assert _lib.LAUNCHES["enc_pred"] > 0 and _lib.LAUNCHES["enc_rice"] > 0


def test_encode_pipeline_overlap_on_card(cuda):
    """Host/device overlap: with one frame per chunk the pack worker
    reads chunk k-1's pinned planes while chunk k runs; it must wait on
    each chunk's CUDA event first, so every payload equals the host
    encoder's (mono, stereo, partial and silent frames)."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.codec.cookie import default_cookie
    from alacnet_tpu_torch.codec.encoder_device import encode_frames_device

    rng = np.random.default_rng(5)
    S = 4096

    def tone(n, ch):
        t = np.arange(n)[:, None]
        x = 9000 * np.sin(t * 0.01 * (1 + np.arange(ch))) + rng.normal(0, 60, (n, ch))
        return x.astype(np.int32)

    frames = [tone(S, 2), tone(S, 1), np.zeros((S, 2), np.int32), tone(S // 2 + 9, 2),
              tone(17, 1)] * 3
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = at.EncoderConfig(order=6)
    got = encode_frames_device(frames, params, cfg, chunk_frames=1, device="cuda")
    host = at.AlacEncoder(params, cfg)
    assert got == [host.encode_frame(f) for f in frames]


# ---------------------------------------------------------------------------
# rice_emit: the Rice emitter with unmerged symbol planes.
# ---------------------------------------------------------------------------


def _check_rice_emit(errs, zr, n, rp, S):
    """Kernel against plain: every plane bit for bit, everywhere (values
    also where their width is 0)."""
    from alacnet_tpu_torch.ops.cuda.rice_emit import rice_symbols_fused

    got = rice_symbols_fused(errs, zr, n, rp, S, kernel="cuda")
    torch.cuda.synchronize()
    want = rice_symbols_fused(errs, zr, n, rp, S, kernel="torch")
    for name, g, w in zip(("vals16", "vals32", "widths", "bad"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("B", [1, 33, 2048])
@pytest.mark.parametrize("S", [1, 255, 4096])
def test_rice_emit_kernel_matches_plain(cuda, B, S):
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.cuda.enc_stages import predictor_errors_fused
    from alacnet_tpu_torch.ops.encode import zero_run_lengths

    sig, n, lp, rp = _enc_inputs(B, S, 6, cuda)
    errs = predictor_errors_fused(sig, n, lp, S, max_order=6, kernel="cuda")
    zr = zero_run_lengths(errs, n, S)
    before = _lib.LAUNCHES["rice_emit"]
    _check_rice_emit(errs, zr, n, rp, S)
    assert _lib.LAUNCHES["rice_emit"] == before + 1


@pytest.mark.parametrize("case", TROUBLE_CASES)
def test_rice_emit_trouble_points(cuda, case):
    from alacnet_tpu_torch.ops.cuda.enc_stages import predictor_errors_fused
    from alacnet_tpu_torch.ops.encode import zero_run_lengths

    d = trouble_inputs(case)
    lp, rp = trouble_params(d, cuda)
    sig, n = (torch.from_numpy(d[k]).to(cuda) for k in ("sig", "n"))
    S = sig.shape[1]
    if d["errs"] is None:
        errs = predictor_errors_fused(sig, n, lp, S, max_order=d["max_order"])
    else:
        errs = torch.from_numpy(d["errs"]).to(cuda)
    _check_rice_emit(errs, zero_run_lengths(errs, n, S), n, rp, S)


def test_alac_context_readahead_on_card(cuda):
    """An AlacContext on the card with window=2: the readahead decodes on
    its worker thread across at least three windows, bit-exact to the
    expected PCM; close() leaves no window in flight."""
    import hashlib

    import alacnet_tpu_torch
    from alacnet_tpu_torch.ops.cuda import _lib

    expected = json.loads((SMOKE / "expected.json").read_text())
    name = "music.m4a"
    before = _lib.LAUNCHES["rice_lpc"]
    ctx = alacnet_tpu_torch.AlacContext(
        io.BytesIO((SMOKE / name).read_bytes()), window=2, device="cuda"
    )
    pcm = ctx.read_all()
    ctx.close()
    assert ctx.prefetch_hits >= 3
    want = expected[name]
    le = np.dtype(want["dtype"]).newbyteorder("<")
    assert hashlib.sha256(pcm.astype(le).tobytes()).hexdigest() == want["sha256"]
    assert _lib.LAUNCHES["rice_lpc"] > before
