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
# The decode kernels' structure: rice_lpc's order buckets, word-ring chunks
# and residual-ring slots; pack_rows's vector and scalar paths.
# ---------------------------------------------------------------------------

#: Orders at every edge of rice_lpc's order buckets (4, 6, 8, 12, 16, 31).
BUCKET_EDGE_ORDERS = (0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 16, 17, 30, 31)
#: Frame length of the synthetic lanes (the plain version runs a Python
#: loop over samples, so it stays short; it still spans 32 residual-ring
#: slots and many word-ring chunks).
LPC_FRAME = 1024


def lpc_frames(orders, seed=0):
    """Encoded stereo 16-bit frames, one per order, each with a silence
    (samples 40-199; zero runs across several 32-sample slots), a
    full-scale noise burst of escapes (300-419) and
    a music-like rest; the last frame is partial (777 samples, not a
    multiple of a slot).  Returns (payloads, CodecParams)."""
    from alacnet_tpu_torch.codec.cookie import default_cookie
    from alacnet_tpu_torch.codec.encoder import AlacEncoder, EncoderConfig

    params = default_cookie(44100, 16, 2, LPC_FRAME)
    rng = np.random.default_rng(seed)
    payloads = []
    for f, order in enumerate(orders):
        t = np.arange(LPC_FRAME)[:, None]
        pcm = 2500 * np.sin(t * (0.01 + 0.003 * f) + np.array([0, 1])) + rng.normal(0, 30, (LPC_FRAME, 2))
        pcm[40:200] = 0
        pcm[300:420] = rng.integers(-32768, 32768, (120, 2))
        pcm = np.clip(pcm, -32768, 32767).astype(np.int32)
        if f == len(orders) - 1:
            pcm = pcm[:777]
        enc = AlacEncoder(params, EncoderConfig(order=order))
        payloads.append(enc.encode_frame(pcm))
    return payloads, params


def lpc_batch(orders, B, dev, seed=0):
    """B lanes cycling over the frames of ``lpc_frames(orders)``, as the
    decode path hands them to fused_rice_lpc: (words, meta).  Every 5th
    lane has n = 0 beside live ones."""
    from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays

    payloads, params = lpc_frames(orders, seed)
    fb = parse_frame_headers_vec([payloads[i % len(payloads)] for i in range(B)], params)
    assert set(fb.order[:, 0].tolist()) == set(orders[:B])
    fb.n_samples[np.arange(B) % 5 == 3] = 0
    words = torch.from_numpy(np.ascontiguousarray(fb.words).view(np.int32)).to(dev)
    meta = FrameMetaArrays.from_packed(FrameMetaArrays.pack_host(fb), dev)
    return words, meta


def lpc_channels(words, m, fn, S=LPC_FRAME, **kw):
    """Channel A, then channel B from A's end, as frame_decode runs them;
    returns [(out, end), (out, end)].  ``max_order`` as the decode path
    computes it: the largest live order below 31."""
    n = torch.where(m.is_compressed, torch.clamp(m.n_samples, 0, S), 0)
    live = (n > 0)[:, None] & torch.ones_like(m.order, dtype=torch.bool)
    orders = m.order[live & (m.order != 31)]
    max_order = int(orders.max()) if orders.numel() else 0
    res, start = [], m.entropy_pos
    for c, nc in ((0, n), (1, torch.where(m.is_stereo, n, 0))):
        out, end = fn(words, start, nc, m.rss, m.kmod, m.init_history,
                      m.rice_mult[:, c], m.kmask, m.order[:, c], m.quant[:, c],
                      m.rc[:, c].contiguous(), S, max_order=max_order, **kw)
        res.append((out, end))
        start = torch.clamp(end, min=0)
    return res


def _check_rice_lpc(words, m):
    from alacnet_tpu_torch.ops.cuda.rice_lpc import fused_rice_lpc

    got = lpc_channels(words, m, fused_rice_lpc, kernel="cuda")
    torch.cuda.synchronize()
    want = lpc_channels(words, m, fused_rice_lpc, kernel="torch")
    for (go, ge), (wo, we) in zip(got, want):
        assert torch.equal(go, wo) and torch.equal(ge, we)
    return want


@pytest.mark.parametrize("orders", [(0, 1, 4), (5, 6), (7, 8), (9, 12), (13, 16),
                                    (17, 30, 31), BUCKET_EDGE_ORDERS],
                         ids=lambda o: "-".join(map(str, o)))
def test_rice_lpc_order_buckets(cuda, orders):
    """Each order bucket at its edges (and one batch of all of them, the
    widest bucket), channel B from channel A's end, n = 0 lanes."""
    words, m = lpc_batch(orders, 3 * len(orders), cuda)
    _check_rice_lpc(words, m)


@pytest.mark.parametrize("B", [1, 33, 128, 4096])
def test_rice_lpc_lane_counts(cuda, B):
    """One lane, a partial block, the session window's 128 lanes and a
    pooled span's 4096."""
    from alacnet_tpu_torch.ops.cuda import _lib

    words, m = lpc_batch(BUCKET_EDGE_ORDERS, B, cuda)
    _lib.reset_launches()
    _check_rice_lpc(words, m)
    assert _lib.LAUNCHES["rice_lpc"] == 2


def test_rice_lpc_zero_runs_and_escapes_cross_ring_chunks(cuda):
    """The silence gives zero residuals over samples ~50-199, coded as
    zero runs once the Rice history has decayed, across residual-ring
    slots of 32 samples; the noise burst is a string of escapes over
    several 16-word chunks of the word ring.  Both sides agree."""
    from alacnet_tpu_torch.ops.rice import RiceParams, rice_decode

    words, m = lpc_batch((8,), 1, cuda)
    n = torch.clamp(m.n_samples, 0, LPC_FRAME)
    err, end = rice_decode(words, m.entropy_pos, n, RiceParams(
        m.rss, m.kmod, m.init_history, m.rice_mult[:, 0], m.kmask), LPC_FRAME)
    assert (err[0, 56:192] == 0).all()  # zero residuals across slot edges
    assert err[0, 300:420].abs().max() > 1 << 12  # escapes
    # the burst's codes span more than one 16-word chunk
    assert int(end[0]) - int(m.entropy_pos[0]) > 32 * 16 * 2
    _check_rice_lpc(words, m)


def test_rice_lpc_cursor_reaches_row_end(cuda):
    """Rows cut two words past the furthest bit any lane consumes, so the
    kernel's last reads clip to the row's last word and its word ring's
    last chunk is partial; the plain version's window still holds every
    consumed bit, so the two must agree."""
    from alacnet_tpu_torch.ops.cuda.rice_lpc import fused_rice_lpc

    words, m = lpc_batch((4, 8, 31), 6, cuda)
    ends = [e for _, e in lpc_channels(words, m, fused_rice_lpc, kernel="torch")]
    W = int(torch.maximum(*ends).max()) // 32 + 2
    W += W % 16 == 0  # keep the ring's last chunk partial
    assert W < words.shape[1]
    _check_rice_lpc(words[:, :W].contiguous(), m)


def random_lpc_inputs(seed, B=40, W=2048, S=400):
    """NumPy int32 inputs of fused_rice_lpc (words, start, n, rss, kmod,
    init_history, mult, kmask, order, quant, rc) from random rows: a
    quarter of the rows mostly one bits (long unary prefixes: escapes),
    a quarter mostly zero bits (short codes, zero runs); parameters in
    the ranges a stream header gives (kmask = 2**kmod - 1, coefficients
    zero past the order, the Rice multiplier ricemod * (historymult / 4)
    up to 7 * 63).  Rows are wide enough that no lane's cursor nears
    their end."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-(1 << 31), 1 << 31, (B, W), dtype=np.int64).astype(np.int32)
    words[::4] |= rng.integers(0, 1 << 30, (len(range(0, B, 4)), W)).astype(np.int32) << 1
    words[1::4] &= rng.integers(0, 1 << 8, (len(range(1, B, 4)), W)).astype(np.int32)
    order = rng.integers(0, 32, B)
    kmod = rng.integers(0, 16, B)
    cols = (rng.integers(0, 64, B), rng.integers(0, S + 1, B),
            rng.choice([16, 17, 20, 21, 24, 25], B), kmod, rng.integers(0, 1 << 16, B),
            rng.integers(0, 7 * 63 + 1, B), (1 << kmod) - 1, order, rng.integers(0, 16, B))
    rc = np.where(np.arange(32)[None, :] <= order[:, None],
                  rng.integers(-3000, 3000, (B, 32)), 0)
    return tuple(np.ascontiguousarray(a, np.int32) for a in (words, *cols, rc)), S


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rice_lpc_random_rows(cuda, seed):
    """Random rows and header-range parameters, every order bucket."""
    from alacnet_tpu_torch.ops.cuda.rice_lpc import fused_rice_lpc

    arrays, S = random_lpc_inputs(seed)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    order = arrays[8]
    max_order = int(order[order != 31].max())
    out, end = fused_rice_lpc(*args, S, max_order=max_order, kernel="cuda")
    torch.cuda.synchronize()
    p_out, p_end = fused_rice_lpc(*args, S, kernel="torch")
    assert torch.equal(out, p_out) and torch.equal(end, p_end)


@pytest.mark.parametrize("W", [256, 257, 258, 259, 1027])
@pytest.mark.parametrize("B", [1, 4096])
def test_pack_rows_paths(cuda, B, W):
    """W % 4 in {0, 1, 2, 3} (vector and scalar paths); nbytes of 0,
    1-3, ordinary and past 4 W; ow below 0 and past L - W (clipped) and
    at every word offset mod 4."""
    from alacnet_tpu_torch.ops.cuda.pack_rows import blob_words, pack_rows

    rng = np.random.default_rng(W + B)
    blob = rng.integers(0, 256, 4 * W * 8 + 13, dtype=np.uint8)
    bw = blob_words(blob, cuda, max_w=W + 8)
    L = bw.numel()
    ow = rng.integers(0, L - W, B).astype(np.int32)
    nb = rng.integers(0, 4 * W + 1, B).astype(np.int32)
    special_ow = [-5, L - W + 3, 0, L - W, 1, 2, 3]
    special_nb = [0, 1, 2, 3, 4 * W + 9, 4 * W, 5]
    k = min(B, len(special_ow))
    ow[:k], nb[:k] = special_ow[:k], special_nb[:k]
    ow_t, nb_t = torch.from_numpy(ow).to(cuda), torch.from_numpy(nb).to(cuda)
    got = pack_rows(bw, ow_t, nb_t, W, kernel="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, pack_rows(bw, ow_t, nb_t, W, kernel="torch"))
    # a blob view off 16-byte alignment takes the scalar path
    off = bw.reshape(-1)[1:]
    got = pack_rows(off, ow_t, nb_t, W, kernel="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, pack_rows(off, ow_t, nb_t, W, kernel="torch"))


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


def _check_enc(sig, n, lp, rp, S, max_order, errs=None):
    """enc_pred, then enc_rice on its residuals (or on ``errs``), each
    against its plain version bit for bit; returns the plain outputs."""
    from alacnet_tpu_torch.ops.cuda.enc_stages import (
        predictor_errors_fused, rice_merge_fused,
    )
    from alacnet_tpu_torch.ops.encode import zero_run_lengths

    got = predictor_errors_fused(sig, n, lp, S, max_order=max_order, kernel="cuda")
    torch.cuda.synchronize()
    want = predictor_errors_fused(sig, n, lp, S, max_order=max_order, kernel="torch")
    assert torch.equal(got, want)
    errs = want if errs is None else errs
    zr = zero_run_lengths(errs, n, S)
    got = rice_merge_fused(errs, zr, n, rp, S, kernel="cuda")
    torch.cuda.synchronize()
    ref = rice_merge_fused(errs, zr, n, rp, S, kernel="torch")
    for name, g, w in zip(("c0", "c1", "c2", "ws", "bits", "bad"), got, ref):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    return want, zr, ref


@pytest.mark.parametrize("S", [1, 15, 16, 17, 31, 32, 33, 95, 96, 97])
def test_enc_kernels_tile_edges(cuda, S):
    """S below one tile, at a tile's edge and one either side (enc_pred's
    tiles are 32 samples, enc_rice's 16; its ring holds 6 tiles)."""
    sig, n, lp, rp = _enc_inputs(33, S, 6, cuda, seed=S)
    _check_enc(sig, n, lp, rp, S, 6)


@pytest.mark.parametrize("B", [1, 15, 16, 17, 31, 33, 2048, 2049])
def test_enc_kernels_lane_counts(cuda, B):
    """One lane, a block's edges (16 lanes), a chunk's 2048 lanes and one
    more; lanes whose residuals desync the emitter set ``bad``."""
    sig, n, lp, rp = _enc_inputs(B, 100, 8, cuda)
    _, _, ref = _check_enc(sig, n, lp, rp, 100, 8)
    if B >= 33:  # lanes 10, 21 and 32 carry unconstrained int32 values
        assert bool(ref[5].any())


@pytest.mark.parametrize("orders", [(0, 1, 4), (5, 6), (7, 8), (9, 12), (13, 16),
                                    (17, 30)], ids=lambda o: f"{o[0]}-{o[-1]}")
def test_enc_pred_order_buckets(cuda, orders):
    """Each order bucket with mixed orders (order-31 and order-0 lanes
    among them), at max_order and at one above it."""
    from alacnet_tpu_torch.ops.lpc import LpcParams, reverse_coefs

    B, S = 48, 150
    sig, n, lp, rp = _enc_inputs(B, S, 6, cuda, seed=orders[-1])
    rng = np.random.default_rng(orders[0])
    order = rng.integers(orders[0], orders[-1] + 1, B).astype(np.int32)
    order[::7], order[3::11] = 31, 0
    coefs = rng.integers(-2500, 2500, (B, 31)).astype(np.int32)
    coefs[np.arange(31)[None, :] >= order[:, None]] = 0
    T = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    lp = LpcParams(T(order), lp.quant, T(reverse_coefs(coefs, order)), lp.rss)
    mo = int(order[order != 31].max())
    for max_order in sorted({mo, min(mo + 1, 31)}):
        _check_enc(sig, n, lp, rp, S, max_order)


def test_enc_kernels_ragged_and_empty_lanes(cuda):
    """n = 0 lanes, ragged n, a whole block of n = 0 (no tile runs) and
    a block whose longest lane ends mid-tile (the zero tail)."""
    B, S = 80, 200
    sig, n, lp, rp = _enc_inputs(B, S, 6, cuda)
    rng = np.random.default_rng(1)
    nn = rng.integers(0, S + 1, B).astype(np.int32)
    nn[:32] = 0
    nn[32:64] = rng.integers(0, 70, 32)
    nn[40] = 69
    _check_enc(sig, torch.from_numpy(nn).to(cuda), lp, rp, S, 6)


def test_enc_rice_zero_runs_cross_tiles_and_ring(cuda):
    """Silent lanes and lanes of spikes 250 samples apart: zero runs that
    cross tiles and ring slots, and runs longer than the whole ring
    (6 tiles of 16 samples); rice_emit holds on the same inputs."""
    from alacnet_tpu_torch.ops.encode import rice_symbols

    B, S = 36, 700
    sig, n, lp, rp = _enc_inputs(B, S, 6, cuda, seed=9)
    sig[:12] = 0
    sig[12:24] = 0
    sig[12:24, ::250] = 3
    errs, zr, _ = _check_enc(sig, n, lp, rp, S, 6)
    assert int(zr.max()) > 6 * 16
    _check_rice_emit(errs, zr, n, rp, S)
    assert rice_symbols(errs, zr, n, rp, S)[2][:, :, 2].any()  # zero-run symbols


@pytest.mark.parametrize("case", TROUBLE_CASES)
def test_enc_kernels_trouble_points_in_tiles(cuda, case):
    d = trouble_inputs(case)
    lp, rp = trouble_params(d, cuda)
    sig, n = (torch.from_numpy(d[k]).to(cuda) for k in ("sig", "n"))
    errs = None if d["errs"] is None else torch.from_numpy(d["errs"]).to(cuda)
    _check_enc(sig, n, lp, rp, sig.shape[1], d["max_order"], errs)


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


def _rice_emit_inputs(B, S, dev, seed=0):
    """Rice-stage inputs from _enc_inputs' lanes: the predictor's
    residuals, then n set to 0 on every fifth lane and past S on every
    seventh from lane 1 (the residuals past n stay: the values there
    are compared too), and the zero runs for that n."""
    from alacnet_tpu_torch.ops.cuda.enc_stages import predictor_errors_fused
    from alacnet_tpu_torch.ops.encode import zero_run_lengths

    sig, n, lp, rp = _enc_inputs(B, S, 6, dev, seed=seed)
    errs = predictor_errors_fused(sig, n, lp, S, max_order=6)
    n = n.clone()
    n[::5] = 0
    n[1::7] = S + 9
    return errs, zero_run_lengths(errs, n, S), n, rp


@pytest.mark.parametrize("B", [1, 15, 16, 17, 2048])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 4096])
def test_rice_emit_lane_and_tile_edges(cuda, B, S):
    """A block's edges (16 lanes) and a chunk's 2048 lanes, a tile's
    edges (16 samples) and a frame's 4096; lanes of n = 0 and n > S."""
    errs, zr, n, rp = _rice_emit_inputs(B, S, cuda)
    _check_rice_emit(errs, zr, n, rp, S)


@pytest.mark.parametrize("B,S", [(16, 100), (2048, 97)])
def test_rice_emit_misaligned_planes(cuda, B, S):
    """Inputs whose (S, B) storage starts 4 bytes past a 16-byte
    boundary, at B % 16 == 0: the kernel copies and stores one element
    at a time."""
    errs, zr, n, rp = _rice_emit_inputs(B, S, cuda, seed=3)

    def offset(x):  # the same (B, S) values on storage 4 bytes off
        flat = torch.zeros(S * B + 1, dtype=torch.int32, device=cuda)
        flat[1:] = x.t().reshape(-1)
        return flat[1:].view(S, B).t()

    e, z = offset(errs), offset(zr)
    assert e.t().data_ptr() % 16 and torch.equal(e, errs)
    _check_rice_emit(e, z, n, rp, S)


# ---------------------------------------------------------------------------
# bulk_bits: fixed-stride fields at the kernel's edges.
# ---------------------------------------------------------------------------

#: bulk_bits_case kinds: the widest stride the decoder reads (24 + 24), one
#: field (n2 = 0), the extra-bits (8 + 8 or 8) and raw16 strides, lanes of
#: n = 0, n < 0 and n > S, rows of W % 4 == 3 words, a word table 4 bytes
#: past a 16-byte boundary (both: 4-byte staging), fields that run past the
#: row's last word (the clip) and positions that wrap in int32.
BULK_KINDS = ("stride48", "one_field", "extra8", "raw16", "n_edges", "odd_row",
              "misaligned", "clip", "wrap")
#: Kinds whose fields leave the row: the kernel clips each word read and
#: the plain version the window's start (ROADMAP queue 3), so the kernel
#: is held against bulk_bits_clipped alone there.
BULK_MALFORMED = ("clip", "wrap")


def bulk_bits_case(kind, S, B=24, seed=0):
    """NumPy int32 inputs of bulk_bits for one of BULK_KINDS: words (B,
    W), start, n, n1, n2 (B,)."""
    rng = np.random.default_rng(seed + 31 * BULK_KINDS.index(kind) + S)
    lane = np.arange(B)
    n1, n2, n = np.full(B, 24), np.full(B, 24), np.full(B, S)
    if kind == "one_field":
        n1, n2 = np.where(lane % 2, 16, 24), np.zeros(B)
    elif kind == "extra8":
        n1, n2 = np.full(B, 8), np.where(rng.random(B) < 0.5, 8, 0)
    elif kind == "raw16":
        n1 = n2 = np.full(B, 16)
    elif kind == "n_edges":
        n = rng.integers(0, S + 1, B)
        n[::4] = 0
        n[1:4] = [-3, S + 100, 1]
    start = rng.integers(0, 200, B)
    W = (200 + 48 * S) // 32 + 8
    if kind == "odd_row":
        W += (3 - W % 4) % 4
    elif kind == "clip":  # half the row the fields need
        W = max(8, 48 * S // 64)
        start = rng.integers(0, 32 * W, B)
    elif kind == "wrap":
        start = (1 << 31) - rng.integers(1, 48 * S + 64, B)
    words = rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)
    i32 = lambda a: np.asarray(a, np.int64).astype(np.int32)  # noqa: E731
    return words.view(np.int32), i32(start), i32(n), i32(n1), i32(n2)


def bulk_bits_clipped(words, start, n, n1, n2, S):
    """bulk_bits in NumPy as the kernel reads the row: positions wrap in
    int32, and each word read clips to the row (to its last word, and
    below word 0 to words 0 and 1), as the JAX kernel's fetch does."""
    w = words.view(np.uint32).astype(np.uint64)
    B, W = w.shape
    rows = np.arange(B)[:, None]

    def i32(x):
        return (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)

    def field(p, nbits):
        wi = np.clip(p >> 5, 0, W - 1)
        hi, lo = w[rows, wi], w[rows, np.minimum(wi + 1, W - 1)]
        s = (p & 31).astype(np.uint64)
        x = ((hi << s) & 0xFFFFFFFF) | np.where(s == 0, 0, lo >> ((32 - s) & 31))
        return x >> ((32 - nbits.astype(np.int64)) & 31).astype(np.uint64)[:, None]

    stride = (n1.astype(np.int64) + n2) & 0xFFFFFFFF
    pos = i32(start.astype(np.int64)[:, None] + np.arange(S)[None, :] * stride[:, None])
    live = np.arange(S)[None, :] < n[:, None]
    a = np.where(live, field(pos, n1), 0)
    b = np.where(live & (n2 != 0)[:, None], field(i32(pos + n1[:, None]), n2), 0)
    return (a.astype(np.uint32).view(np.int32).reshape(B, S),
            b.astype(np.uint32).view(np.int32).reshape(B, S))


@pytest.mark.parametrize("S", [1, 7, 1023, 1025, 4096])
@pytest.mark.parametrize("kind", BULK_KINDS)
def test_bulk_bits_edges(cuda, kind, S):
    """S below, at and past a block's 1024 samples and not a multiple of
    a thread's 4; the kernel against bulk_bits_clipped everywhere, and
    against the plain version where the fields stay in the row."""
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.cuda.bulk_bits import bulk_bits

    words, start, n, n1, n2 = bulk_bits_case(kind, S)
    T = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    tw = T(words)
    if kind == "misaligned":
        flat = torch.zeros(words.size + 1, dtype=torch.int32, device=cuda)
        flat[1:] = tw.reshape(-1)
        tw = flat[1:].view(words.shape)
        assert tw.data_ptr() % 16
    args = (tw, T(start), T(n), T(n1), T(n2), S)
    before = _lib.LAUNCHES["bulk_bits"]
    a, b, stalled = bulk_bits(*args, kernel="cuda")
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["bulk_bits"] == before + 1
    assert stalled.dtype == torch.bool and stalled.shape == (24,) and not stalled.any()
    want_a, want_b = bulk_bits_clipped(words, start, n, n1, n2, S)
    assert np.array_equal(a.cpu().numpy(), want_a) and np.array_equal(b.cpu().numpy(), want_b)
    if kind not in BULK_MALFORMED:
        plain_a, plain_b, _ = bulk_bits(*args, kernel="torch")
        assert torch.equal(a, plain_a) and torch.equal(b, plain_b)


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


def test_bench_music_on_the_card(cuda):
    """``run_benchmark`` at a small batch on the card: the lossless gate,
    the kernels it times, and event-timed numbers."""
    from alacnet_tpu_torch.bench_lib import run_benchmark

    rec = run_benchmark(batch=256, kind="music", device="cuda", dispersion=2)
    assert rec["parity_ok"] is True
    assert rec["device"]["type"] == "cuda" and rec["device"]["count"] >= 1
    assert rec["value"] > 0 and rec["device_s"] > 0 and rec["host_enqueue_s"] > 0
    assert len(rec["device_runs_s"]) == 2 and rec["dispersion"]["n"] == 2
    assert rec["fused_kernel"] is True
    assert rec["kernel_launches"]["rice_lpc"] > 0 and rec["kernel_launches"]["pack_rows"] > 0


def test_bench_mono_with_host_on_the_card(cuda, tmp_path, monkeypatch):
    """``run_benchmark(channels=1, include_host=True)``: the mono corpus
    through the kernels, the host stage in the published rate only
    (below the device stage's own), ``host_parse_s`` spanning the host
    stage, and the traced pass's busy device time."""
    import time

    from alacnet_tpu_torch import bench_lib

    walls, stage = [], bench_lib._stage

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = stage(*args, **kwargs)
        walls.append(time.perf_counter() - t0)
        return out

    monkeypatch.setattr(bench_lib, "_stage", timed)
    t0 = time.perf_counter()
    rec = bench_lib.run_benchmark(batch=256, kind="music", channels=1, include_host=True,
                                  device="cuda", dispersion=2, trace_dir=str(tmp_path))
    wall = time.perf_counter() - t0
    dev = bench_lib.run_benchmark(batch=256, kind="music", channels=1, device="cuda",
                                  dispersion=2)
    assert rec["parity_ok"] is True and dev["parity_ok"] is True
    assert rec["include_host"] is True and dev["include_host"] is False
    assert "1ch" in rec["metric"] and rec["total_samples"] == 256 * 4096
    assert 0 < walls[0] <= rec["host_parse_s"] < wall
    assert rec["value"] == rec["total_samples"] / (rec["device_s"] + rec["host_parse_s"]) / 1e6
    assert rec["value"] < dev["value"]
    # the dispersion rates stay the device stage's
    assert rec["dispersion"]["min_msps"] > rec["value"]
    assert any("rice_lpc" in op for op in rec["device_ms_by_op"])
    assert rec["device_busy_ms"] > 0 and rec["device_busy_share"] > 0
    # ops whose names share a prefix add up: the by-op list sums to the busy time
    by_op = sum(rec["device_ms_by_op"].values())
    assert by_op <= rec["device_busy_ms"] * (1 + 1e-9)
    if len(rec["device_ms_by_op"]) < 12:
        assert by_op == pytest.approx(rec["device_busy_ms"], rel=1e-9)
    assert rec["kernel_launches"]["rice_lpc"] > 0 and rec["kernel_launches"]["pack_rows"] > 0


# ---------------------------------------------------------------------------
# The mesh (parallel/mesh.py): two shards on one card, each on its stream.
# ---------------------------------------------------------------------------

#: Copies of each smoke file in the mesh tests: at 8, each of two shards
#: gets extra-bits or raw lanes, so every decode kernel runs on both.
MESH_COPIES = 8


def _pooled_smoke(copies):
    expected = json.loads((SMOKE / "expected.json").read_text())
    names = sorted(expected)
    data = {n: (SMOKE / n).read_bytes() for n in names}
    return expected, names, [io.BytesIO(data[n]) for n in names for _ in range(copies)]


def _launch_streams(monkeypatch, cards=False):
    """Record (kernel, raw stream handle) of every launch from now on;
    with ``cards``, (kernel, card index, handle): the handles of two
    cards' default streams are equal."""
    import collections

    from alacnet_tpu_torch.ops.cuda import _lib

    seen = collections.Counter()
    orig = _lib.launch

    def rec(name, device, *args):
        index = device.index if device.index is not None else torch.cuda.current_device()
        handle = torch._C._cuda_getCurrentRawStream(index)
        kernel = name.removeprefix("alac_")
        seen[(kernel, index, handle) if cards else (kernel, handle)] += 1
        return orig(name, device, *args)

    monkeypatch.setattr(_lib, "launch", rec)
    return seen


def test_two_shard_mesh_on_one_card_matches_single_device(cuda):
    """decode_streams and encode_frames_device over two shards on
    cuda:0 equal the single device (and expected.json), lane for lane
    and byte for byte."""
    import hashlib

    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.codec.encoder_device import encode_frames_device
    from alacnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(["cuda:0", "cuda:0"])
    expected, names, streams = _pooled_smoke(1)
    single = at.decode_streams(streams, device="cuda")
    expected, names, streams = _pooled_smoke(1)
    meshed = at.decode_streams(streams, mesh=mesh)
    for name, s, m in zip(names, single, meshed):
        assert m.pcm.dtype == s.pcm.dtype
        np.testing.assert_array_equal(m.pcm, s.pcm)
        le = m.pcm.dtype.newbyteorder("<")
        assert hashlib.sha256(m.pcm.astype(le).tobytes()).hexdigest() == expected[name]["sha256"]
    music = next(r for n, r in zip(names, single) if n == "music.m4a")
    S = 4096
    frames = [music.pcm[i : i + S] for i in range(0, music.pcm.shape[0], S)][:7]
    frames[2] = frames[2][:1000]
    params = at.default_cookie(music.sample_rate, 16, 2)
    want = encode_frames_device(frames, params, device="cuda")
    assert encode_frames_device(frames, params, mesh=mesh) == want
    host = at.AlacEncoder(params)
    assert want == [host.encode_frame(f) for f in frames]


def test_mesh_launches_each_kernel_on_each_shard_stream(cuda, monkeypatch):
    """Under a two-shard mesh, pack_rows, rice_lpc and bulk_bits launch
    on both shard streams (and on no other), blob_words once for the
    one distinct device, on its current stream, before the shards'
    work; and the encode kernels (the prologue and the pair merge among
    them) on both shard streams."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(["cuda:0", "cuda:0"])
    handles = [s.cuda_stream for s in mesh.streams]
    assert len(set(handles)) == 2
    seen = _launch_streams(monkeypatch)
    _, names, streams = _pooled_smoke(MESH_COPIES)
    current = torch.cuda.current_stream().cuda_stream
    decoded = at.decode_streams(streams, mesh=mesh)
    for k in ("pack_rows", "rice_lpc", "bulk_bits"):
        assert all(seen[(k, h)] > 0 for h in handles), (k, seen)
    assert {h for k, h in seen if k != "blob_words"} == set(handles)
    assert {(k, h): c for (k, h), c in seen.items() if k == "blob_words"} == {
        ("blob_words", current): 1}
    seen.clear()
    music = decoded[names.index("music.m4a") * MESH_COPIES]
    at.encode_files([music.pcm] * 3, [io.BytesIO() for _ in range(3)],
                    music.sample_rate, 16, mesh=mesh)
    for k in ("enc_prologue", "enc_pred", "enc_rice", "zero_runs", "pair_merge"):
        assert all(seen[(k, h)] > 0 for h in handles), (k, seen)


def test_one_device_decode_runs_on_the_current_stream(cuda, monkeypatch):
    """A decode without a mesh runs on a mesh of one shard that makes no
    CUDA stream: every kernel launches on the calling thread's current
    stream (here one of the test's own), and the PCM is expected.json's."""
    import hashlib

    import alacnet_tpu_torch as at

    caller = torch.cuda.Stream()
    real = torch.cuda.Stream
    made = []

    class Counted(real):
        def __new__(cls, device=None, priority=0, **kwargs):
            if "stream_id" not in kwargs:  # a new stream, not a handle to one
                made.append(device)
            return super().__new__(cls, device, priority, **kwargs)

    monkeypatch.setattr(torch.cuda, "Stream", Counted)
    seen = _launch_streams(monkeypatch)
    expected, names, streams = _pooled_smoke(MESH_COPIES)
    with torch.cuda.stream(caller):
        decoded = at.decode_streams(streams, device="cuda")
    assert made == []
    assert {k for k, _ in seen} >= {"blob_words", "pack_rows", "rice_lpc", "dec_epilogue"}
    assert {h for _, h in seen} == {caller.cuda_stream}, seen
    for i, r in enumerate(decoded):
        le = r.pcm.dtype.newbyteorder("<")
        want = expected[names[i // MESH_COPIES]]["sha256"]
        assert hashlib.sha256(r.pcm.astype(le).tobytes()).hexdigest() == want


#: Copies of each smoke file in the pooled decode over every card, as
#: chip_smoke.py's COPIES.
CARD_COPIES = 96


@pytest.fixture
def cards(cuda):
    """Every visible card, where there are two or more."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs two or more CUDA cards: {count} visible")
    return [torch.device("cuda", i) for i in range(count)]


def test_mesh_over_every_card_matches_one_card(cards):
    """decode_streams(mesh=make_mesh()) over every visible card equals
    one card's PCM (and expected.json), file for file."""
    import hashlib

    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    assert list(mesh.devices) == cards
    expected, names, streams = _pooled_smoke(MESH_COPIES)
    single = at.decode_streams(streams, device="cuda:0")
    _, _, streams = _pooled_smoke(MESH_COPIES)
    meshed = at.decode_streams(streams, mesh=mesh)
    for i, (s, m) in enumerate(zip(single, meshed)):
        assert m.pcm.dtype == s.pcm.dtype
        np.testing.assert_array_equal(m.pcm, s.pcm)
        le = m.pcm.dtype.newbyteorder("<")
        want = expected[names[i // MESH_COPIES]]["sha256"]
        assert hashlib.sha256(m.pcm.astype(le).tobytes()).hexdigest() == want


def test_one_device_decode_on_another_card(cards):
    """decode_streams(device="cuda:1") from a thread whose current card
    is cuda:0 equals the cuda:0 decode, file for file."""
    import alacnet_tpu_torch as at

    _, _, streams = _pooled_smoke(MESH_COPIES)
    with torch.cuda.device(0):
        first = at.decode_streams(streams, device="cuda:0")
        _, _, streams = _pooled_smoke(MESH_COPIES)
        second = at.decode_streams(streams, device="cuda:1")
        assert torch.cuda.current_device() == 0
    for a, b in zip(first, second, strict=True):
        assert b.pcm.dtype == a.pcm.dtype
        np.testing.assert_array_equal(b.pcm, a.pcm)


def test_mesh_launches_each_kernel_on_each_cards_stream(cards, monkeypatch):
    """Over every card, each decode and encode kernel launches on each
    card's shard stream and on no other stream; blob_words once a card,
    on that card's current stream."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    shards = {(d.index, s.cuda_stream) for d, s in zip(mesh.devices, mesh.streams)}
    current = {(d.index, torch.cuda.current_stream(d).cuda_stream) for d in cards}
    seen = _launch_streams(monkeypatch, cards=True)
    # at 96 copies each of up to 8 shards holds raw-frame lanes (bulk_bits)
    _, names, streams = _pooled_smoke(CARD_COPIES)
    decoded = at.decode_streams(streams, mesh=mesh)
    for k in ("pack_rows", "rice_lpc", "bulk_bits", "dec_epilogue"):
        assert all(seen[(k, *sh)] > 0 for sh in shards), (k, seen)
    assert {(i, h) for k, i, h in seen if k != "blob_words"} == shards
    assert {(i, h): c for (k, i, h), c in seen.items() if k == "blob_words"} == dict.fromkeys(
        current, 1)
    seen.clear()
    music = decoded[names.index("music.m4a") * CARD_COPIES]
    at.encode_files([music.pcm] * len(cards), [io.BytesIO() for _ in cards],
                    music.sample_rate, 16, mesh=mesh)
    for k in ("enc_prologue", "enc_pred", "enc_rice", "zero_runs", "pair_merge"):
        assert all(seen[(k, *sh)] > 0 for sh in shards), (k, seen)
    assert {(i, h) for _, i, h in seen} == shards


def test_encode_frames_device_over_every_card_matches_host(cards):
    """encode_frames_device(mesh=) over every card: a ragged slice (a
    partial frame, a frame count that does not split evenly) byte for
    byte against the host encoder and one card."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.codec.encoder_device import encode_frames_device
    from alacnet_tpu_torch.parallel.mesh import make_mesh

    _, names, streams = _pooled_smoke(1)
    music = at.decode_streams(streams, device="cuda")[names.index("music.m4a")]
    S = 4096
    frames = [music.pcm[i : i + S] for i in range(0, music.pcm.shape[0], S)]
    frames = frames[: 2 * len(cards) + 1]
    frames[1] = frames[1][:1000]
    params = at.default_cookie(music.sample_rate, 16, 2)
    host = at.AlacEncoder(params)
    want = [host.encode_frame(f) for f in frames]
    assert encode_frames_device(frames, params, device="cuda:0") == want
    assert encode_frames_device(frames, params, mesh=make_mesh()) == want


def test_cli_batch_decode_mesh_over_every_card(cards, tmp_path, capsys):
    """``alac-tpu-torch batch-decode --mesh`` (decode_files over
    make_mesh(), every visible card) writes the WAV files that one card
    writes."""
    from alacnet_tpu_torch import cli

    paths = sorted(str(p) for p in SMOKE.glob("*.m4a"))
    for mesh in (False, True):
        args = ["batch-decode", *paths, "--out-dir", str(tmp_path / f"d{int(mesh)}")]
        assert cli.main(args + ["--mesh"] * mesh) == 0
    capsys.readouterr()
    wavs = sorted(p.name for p in (tmp_path / "d0").iterdir())
    assert len(wavs) == len(paths)
    for name in wavs:
        assert (tmp_path / "d1" / name).read_bytes() == (tmp_path / "d0" / name).read_bytes()


def test_dryrun_multichip_over_every_card(cards):
    from alacnet_tpu_torch.parallel.mesh import dryrun_multichip

    rec = dryrun_multichip(len(cards))
    assert rec["devices"] == [str(d) for d in cards]
    assert rec["shards"] == len(cards) and rec["encoded_frames"] == 2 * len(cards) + 1


# ---------------------------------------------------------------------------
# The encoder's packing routes: the device packers and quad packing.
# ---------------------------------------------------------------------------


def pack_planes(rng):
    """The JAX package's adversarial chunk planes for the device packers
    (tests/test_encoder_tpu.py), as numpy: ((c0, c1, c2) uint32, ws
    int8), n, stereo, hbits.  Dense 1-bit runs (33+ symbols in one
    32-bit word, the K = 34 gather window's worst case), 81-bit chunks
    spanning words, zero-width gaps, mono and partial frames."""
    F, S2 = 6, 160
    n = np.array([160, 160, 97, 160, 1, 160], np.int32)
    stereo = np.array([1, 1, 0, 1, 1, 0], bool)
    hbits = np.array([61, 3, 32, 17, 80, 1], np.int32)
    B = 2 * F
    ws = np.zeros((B, S2), np.int8)
    ws[0] = 1
    ws[1] = rng.integers(0, 12, S2)
    ws[2, ::4] = np.int8(81)
    ws[3] = rng.integers(0, 3, S2)
    ws[4, 0] = 33
    ws[5] = rng.integers(0, 96, S2) % 33
    for lane in range(6, B):
        ws[lane] = rng.integers(0, 14, S2)
    r = rng.integers(0, 1 << 32, (3, B, S2), dtype=np.uint64).astype(np.uint32)
    w = ws.astype(np.int64)
    c2 = np.where(w >= 32, r[2], r[2] & ((1 << np.minimum(w, 31)) - 1))
    wm = np.clip(w - 32, 0, 32)
    c1 = np.where(wm >= 32, r[1], r[1] & ((1 << np.minimum(wm, 31)) - 1))
    wh = np.clip(w - 64, 0, 32)
    c0 = np.where(wh >= 32, r[0], r[0] & ((1 << np.minimum(wh, 31)) - 1))
    planes = tuple(x.astype(np.uint32) for x in (c0, c1, c2))
    return (*planes, ws), n, stereo, hbits


def _music_chunk(F, S=4096, seed=0):
    """F frames of 16-bit stereo music and, last, one frame of full-range
    noise (its quads pass 96 bits)."""
    rng = np.random.default_rng(seed)
    t = np.arange(F * S)[:, None]
    x = 4000 * np.sin(t * 0.013 + np.arange(2)) + 1500 * np.sin(t * 0.0913) \
        + rng.normal(0, 30, (F * S, 2))
    frames = list(x.astype(np.int32).reshape(F, S, 2))
    frames[-1] = rng.integers(-32768, 32767, (S, 2)).astype(np.int32)
    return frames


@pytest.mark.parametrize("impl", ["pack_frames_device", "pack_frames_device_scatter"])
def test_device_packers_on_card_match_cpu(cuda, impl):
    """Both device packers on CUDA tensors against their own CPU run, bit
    for bit: the adversarial planes, and a 1,024-frame chunk's classic
    planes as the encoder dispatches them."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.codec import encoder_device as ed
    from alacnet_tpu_torch.ops import encode

    fn = getattr(encode, impl)
    (c0, c1, c2, ws), n, stereo, hbits = pack_planes(np.random.default_rng(11))
    host = [torch.from_numpy(np.ascontiguousarray(x).view(np.int32) if x.dtype == np.uint32
                             else x) for x in (c0, c1, c2, ws, n, stereo, hbits)]
    want = fn(*host, stride_words=256)
    got = fn(*(x.to(cuda) for x in host), stride_words=256)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))

    frames = _music_chunk(1024)
    params = at.default_cookie(44100, 16, 2)
    cfg = at.EncoderConfig()
    prep = ed._prep(frames, params, cfg, at.AlacEncoder(params, cfg))
    fetch = ed._dispatch(prep, params, cfg, cuda, pack="scatter")
    stride = ed._pack_stride(prep, fetch.get(4)[0])
    hb = torch.from_numpy(prep["hbits"].astype(np.int32))
    args = (*fetch.planes[:4], torch.from_numpy(prep["ns_f"]),
            torch.from_numpy(prep["stereo_f"]), hb)
    got = fn(*(a.to(cuda) for a in args), stride_words=stride)
    want = fn(*(a.cpu() for a in args), stride_words=stride)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.parametrize("route", [dict(pack="scatter"), dict(pack="gather"),
                                   dict(quads=True)], ids=["scatter", "gather", "quads"])
def test_encode_routes_on_card_match_host(cuda, route):
    """Each packing route on the card, chunks of 4 frames: mono, partial,
    silent and music frames, and a full-range noise frame, which the
    quad route repacks from its pair rows."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.codec.encoder_device import encode_frames_device

    S = 4096
    frames = _music_chunk(7)
    frames[1] = frames[1][:, :1]
    frames[2] = frames[2][: S // 2 + 9]
    frames[4] = np.zeros((S, 2), np.int32)
    params = at.default_cookie(44100, 16, 2)
    cfg = at.EncoderConfig()
    timings = {}
    got = encode_frames_device(frames, params, cfg, timings=timings, chunk_frames=4,
                               device="cuda", **route)
    host = at.AlacEncoder(params, cfg)
    assert got == [host.encode_frame(f) for f in frames]
    if "quads" in route:
        assert timings["quad_chunks"] == 2 and timings["repacked_frames"] == 1
    else:
        assert timings["device_pack_chunks"] == 2


def test_device_pack_from_the_worker_runs_on_the_dispatch_device(cuda, monkeypatch):
    """The pack worker thread launches the device pack on the dispatch's
    device (the last visible card), on a side stream, not on its own
    default device and stream."""
    import threading

    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.codec.encoder_device import encode_frames_device
    from alacnet_tpu_torch.ops import encode

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    seen = []
    real = encode.pack_frames_device_scatter

    def rec(*args, **kw):
        seen.append((threading.current_thread() is threading.main_thread(),
                     torch.cuda.current_device(), torch.cuda.current_stream(),
                     torch.cuda.default_stream(dev), args[0].device))
        return real(*args, **kw)

    monkeypatch.setattr(encode, "pack_frames_device_scatter", rec)
    frames = _music_chunk(3)
    params = at.default_cookie(44100, 16, 2)
    got = encode_frames_device(frames, params, chunk_frames=1, device=dev, pack="scatter")
    host = at.AlacEncoder(params)
    assert got == [host.encode_frame(f) for f in frames]
    assert len(seen) == 3
    for on_main, current, stream, default, tensor_dev in seen:
        assert not on_main and current == dev.index and tensor_dev == dev
        assert stream.device == dev and stream != default


# ---- decode_frames and the fuzz batches (scripts/soak_torch.py) ----


@pytest.mark.parametrize("name", ["hires24.m4a", "raw16.m4a", "mono16.m4a"])
def test_decode_frames_kernel_matches_plain(cuda, name):
    """``decode_frames`` (the metadata as FrameMetaArrays on the card)
    through the kernels and the plain versions, and against
    ``decode_frames_packed``: extra bits and raw frames (``bulk_bits``),
    mono lanes."""
    from alacnet_tpu_torch.batch import _collect
    from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu_torch.ops.frame_decode import (
        FrameMetaArrays, decode_frames, decode_frames_packed,
    )

    info, blob = _collect(io.BytesIO((SMOKE / name).read_bytes()))
    offs, szs = info.tables.frame_file_offsets(), info.tables.frame_byte_sizes
    fb = parse_frame_headers_vec([blob[o: o + s].tobytes() for o, s in zip(offs, szs)],
                                 info.params)
    words = torch.from_numpy(fb.words.view(np.int32)).to(cuda)
    meta = FrameMetaArrays.from_batch(fb, cuda)
    S = info.params.max_samples_per_frame
    got, n = decode_frames(words, meta, S, kernel="cuda")
    want, wn = decode_frames(words, meta, S, kernel="torch")
    packed, pn = decode_frames_packed(words, FrameMetaArrays.pack_host(fb), S, kernel="cuda")
    assert torch.equal(got, want) and torch.equal(n, wn)
    assert torch.equal(got, packed) and torch.equal(n, pn)


def test_fuzz_batches_kernel_matches_plain(cuda):
    """The fuzz batches through ``decode_frames``, kernel against plain:
    every lane whose cursors stay in the row equal (``fuzz_routes``)."""
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
    import soak_torch

    for rec in soak_torch.fuzz_routes("cuda"):
        assert rec["equal"], rec
        assert rec["compared"] > 0.9 * rec["lanes"], rec


# ---- the decode epilogue (dec_epilogue) and the zero-run lookahead (zero_runs)

#: Frame length of the epilogue cases, their frames' lengths (the last
#: partial) and the word-row width every batch is padded to.
EPI_S = 256
EPI_LENGTHS = (EPI_S, EPI_S, 101)
EPI_W = 1024
#: (channels, bits, EncoderConfig keywords, raw middle frame, emit16);
#: tests/test_torch_epilogue.py holds the plain epilogue against JAX on them.
EPILOGUE_CASES = {
    "mono16": (1, 16, {}, False, False),
    "mono16-emit16": (1, 16, {}, False, True),
    "mono16-raw": (1, 16, {}, True, False),
    "mono24": (1, 24, {}, False, False),
    "mono24-ub1": (1, 24, {"uncompressed_bytes": 1}, False, False),
    "mono24-raw": (1, 24, {}, True, False),
    "stereo16-lw0": (2, 16, {"interlacing_shift": 0, "interlacing_leftweight": 0},
                     False, False),
    "stereo16": (2, 16, {}, False, False),
    "stereo16-sh20-lw200": (2, 16, {"interlacing_shift": 20,
                                    "interlacing_leftweight": 200}, False, False),
    "stereo16-emit16": (2, 16, {}, False, True),
    "stereo16-raw": (2, 16, {}, True, False),
    "stereo16-raw-emit16": (2, 16, {}, True, True),
    "stereo24": (2, 24, {}, False, False),
    "stereo24-sh20-lw200": (2, 24, {"interlacing_shift": 20,
                                    "interlacing_leftweight": 200}, False, False),
    "stereo24-ub1": (2, 24, {"uncompressed_bytes": 1}, False, False),
    "stereo24-ub1-lw0": (2, 24, {"uncompressed_bytes": 1, "interlacing_shift": 0,
                                 "interlacing_leftweight": 0}, False, False),
    "stereo24-ub1-sh20-lw200": (2, 24, {"uncompressed_bytes": 1, "interlacing_shift": 20,
                                        "interlacing_leftweight": 200}, False, False),
    "stereo24-raw": (2, 24, {}, True, False),
}


def epilogue_pcm(n, bits, channels, rng):
    """Seeded music-like PCM: a few partials, noise and a silent stretch."""
    t = np.arange(n)[:, None]
    f = rng.uniform(0.002, 0.05, (3, channels))
    x = sum(np.sin(2 * np.pi * f[k] * t + rng.uniform(0, 6)) / (k + 1) for k in range(3))
    x = x * 0.3 + rng.normal(0, 0.02, (n, channels))
    if channels == 2:
        x[:, 1] = 0.7 * x[:, 0] + 0.3 * x[:, 1]  # correlated channels
    x[n // 3 : n // 3 + 17] = 0
    full = (1 << (bits - 1)) - 1
    return np.clip(np.round(x * full), -full - 1, full).astype(np.int32)


def epilogue_frames(name, seed=None):
    """(payloads, params) of one case of ``EPILOGUE_CASES``, made by the
    port's host encoder: ``EPI_LENGTHS`` frames, the middle one
    uncompressed where the case has a raw frame."""
    from alacnet_tpu_torch import AlacEncoder, EncoderConfig, default_cookie

    channels, bits, kw, raw, _ = EPILOGUE_CASES[name]
    seed = sorted(EPILOGUE_CASES).index(name) if seed is None else seed
    rng = np.random.default_rng(seed)
    params = default_cookie(44100, bits, channels, EPI_S)
    enc = AlacEncoder(params, EncoderConfig(**kw))
    enc_raw = AlacEncoder(params, EncoderConfig(**kw, force_uncompressed=True))
    pcm = epilogue_pcm(sum(EPI_LENGTHS), bits, channels, rng)
    out, lo = [], 0
    for i, n in enumerate(EPI_LENGTHS):
        out.append((enc_raw if raw and i == 1 else enc).encode_frame(pcm[lo : lo + n]))
        lo += n
    return out, [params] * len(out)


def epilogue_batch(payloads, params):
    """(the padded frame batch, its word rows as (B, EPI_W) uint32)."""
    from alacnet_tpu_torch.codec.framemeta_vec import parse_frame_headers_blob
    from alacnet_tpu_torch.parallel.pipeline import pad_frame_batch

    blob = np.frombuffer(b"".join(payloads), np.uint8)
    sizes = np.array([len(p) for p in payloads])
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    fb = pad_frame_batch(parse_frame_headers_blob(blob, offs, sizes, params))
    words = np.zeros((fb.batch, EPI_W), np.uint32)
    words[:, : fb.words.shape[1]] = fb.words
    return fb, words


def epilogue_mixed(bits):
    """Every case of one width in one batch (seeds 100 and up)."""
    payloads, params = [], []
    for i, name in enumerate(sorted(EPILOGUE_CASES)):
        if EPILOGUE_CASES[name][1] == bits:
            p, q = epilogue_frames(name, seed=100 + i)
            payloads += p
            params += q
    return epilogue_batch(payloads, params)


def _sync(t):
    if t.is_cuda:
        torch.cuda.synchronize()


def check_decode_epilogue(fb, words, emit16, dev):
    """``decode_frames_packed`` through the kernels and through the plain
    versions, bit for bit; the epilogue kernel launched once."""
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays, decode_frames_packed

    packed = FrameMetaArrays.pack_host(fb)
    w = torch.from_numpy(words.view(np.int32).copy()).to(dev)
    before = _lib.LAUNCHES["dec_epilogue"]
    got, n = decode_frames_packed(w, packed, EPI_S, emit16=emit16, kernel="cuda")
    _sync(got)
    assert _lib.LAUNCHES["dec_epilogue"] == before + 1
    want, wn = decode_frames_packed(w, packed, EPI_S, emit16=emit16, kernel="torch")
    assert got.dtype == want.dtype and torch.equal(got, want) and torch.equal(n, wn)


@pytest.mark.parametrize("name", list(EPILOGUE_CASES))
def test_dec_epilogue_decode_cases(cuda, name):
    check_decode_epilogue(*epilogue_batch(*epilogue_frames(name)),
                          EPILOGUE_CASES[name][4], cuda)


@pytest.mark.parametrize("bits", [16, 24])
def test_dec_epilogue_mixed_batch(cuda, bits):
    check_decode_epilogue(*epilogue_mixed(bits), False, cuda)


#: The epilogue's per-lane columns, in ``decode_epilogue``'s order.
EPILOGUE_COLUMNS = ("is_stereo", "is_compressed", "sample_size", "ub",
                    "interlacing_shift", "interlacing_leftweight", "n")


def epilogue_synthetic(B, S, seed):
    """Six (B, S) int32 planes of any values and per-lane columns the
    encoder cannot make: ub 0-3 on every width (16-bit lanes with ub > 0
    included), sample sizes 8-32, shifts 0-31 and outside, leftweights
    whose product with channel B overflows, n from -1 to S + 3."""
    rng = np.random.default_rng(seed)
    planes = [rng.integers(-(1 << 31), 1 << 31, (B, S), dtype=np.int64).astype(np.int32)
              for _ in range(6)]
    lane = np.arange(B)
    lw = rng.integers(-300, 300, B)
    lw[lane % 5 == 1] = rng.choice([(1 << 31) - 1, -(1 << 31), 1 << 20, -(1 << 24), 65537],
                                   int((lane % 5 == 1).sum()))
    n = rng.integers(0, S + 1, B)
    n[lane % 9 == 4] = S
    n[lane % 13 == 6] = rng.choice([-1, 0, S + 3], int((lane % 13 == 6).sum()))
    cols = dict(
        is_stereo=lane % 3 != 2, is_compressed=lane % 4 != 3,
        sample_size=rng.choice([8, 16, 20, 24, 32], B),
        ub=rng.integers(0, 4, B), interlacing_shift=np.where(lane % 7 == 0, 40, lane % 32),
        interlacing_leftweight=lw, n=n,
    )
    cols = {k: v if v.dtype == bool else v.astype(np.int32) for k, v in cols.items()}
    return planes, cols


def _epilogue_planes(planes, layout, dev):
    """The planes on ``dev``: ``lane_major`` contiguous (B, S);
    ``sample_major`` with out_a/out_b the transposed views of (S, B)
    storage, as the rice_lpc kernel returns them; ``misaligned`` each a
    (B, S) view 4 bytes into a larger buffer (no row 16-byte aligned)."""
    out = []
    for i, p in enumerate(planes):
        t = torch.from_numpy(p).to(dev)
        if layout == "sample_major" and i < 2:
            t = t.t().contiguous().t()
        elif layout == "misaligned":
            buf = torch.zeros(t.numel() + 1, dtype=torch.int32, device=dev)
            buf[1:] = t.reshape(-1)
            t = buf[1:].view(t.shape)
        out.append(t)
    return out


def check_dec_epilogue(planes, cols, S, emit16, layout, dev, absent=()):
    """``decode_epilogue`` through the kernel and the plain version, bit
    for bit; planes in ``absent`` passed as None."""
    from alacnet_tpu_torch.ops.cuda.epilogue import decode_epilogue

    p = [None if i in absent else x
         for i, x in enumerate(_epilogue_planes(planes, layout, dev))]
    c = [torch.from_numpy(cols[k]).to(dev) for k in EPILOGUE_COLUMNS]
    got = decode_epilogue(*p, *c, S, emit16=emit16, kernel="cuda")
    _sync(got)
    want = decode_epilogue(*p, *c, S, emit16=emit16, kernel="torch")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["sample_major", "lane_major", "misaligned"])
@pytest.mark.parametrize("emit16", [False, True])
@pytest.mark.parametrize("B,S", [(1, 1), (33, 255), (40, 256), (130, 1001), (4096, 64)])
def test_dec_epilogue_synthetic(cuda, B, S, emit16, layout):
    planes, cols = epilogue_synthetic(B, S, seed=B + S)
    check_dec_epilogue(planes, cols, S, emit16, layout, cuda)


@pytest.mark.parametrize("absent", [(1,), (2, 3), (4, 5), (1, 2, 3, 4, 5), (0, 1)],
                         ids=["out_b", "extra", "raw", "all-but-a", "compressed"])
@pytest.mark.parametrize("layout", ["sample_major", "lane_major"])
def test_dec_epilogue_absent_planes(cuda, absent, layout):
    planes, cols = epilogue_synthetic(70, 300, seed=len(absent))
    check_dec_epilogue(planes, cols, 300, False, layout, cuda, absent)


def zero_run_case(B, S, zero_share, seed):
    """(errs (B, S) int32, n (B,) int32): residuals zero with probability
    ``zero_share``, lane 0 all zero, and the first lanes' counts at S, 0,
    S + 5, -3 and S // 2."""
    rng = np.random.default_rng(seed)
    errs = rng.integers(-40, 40, (B, S)).astype(np.int32)
    errs[rng.random((B, S)) < zero_share] = 0
    errs[0] = 0
    n = rng.integers(0, S + 1, B).astype(np.int32)
    n[:5] = [S, 0, S + 5, -3, S // 2][: min(5, B)]
    return errs, n


def check_zero_runs(errs, n, dev):
    """``zero_run_lengths_fused`` through the kernel and the plain version
    on the (S, B) plane, bit for bit; returns the runs as (B, S)."""
    from alacnet_tpu_torch.ops.cuda.zero_runs import zero_run_lengths_fused

    e = torch.from_numpy(errs.T.copy()).to(dev)
    nn = torch.from_numpy(n).to(dev)
    got = zero_run_lengths_fused(e, nn, kernel="cuda")
    _sync(got)
    want = zero_run_lengths_fused(e, nn, kernel="torch")
    assert got.dtype == want.dtype and torch.equal(got, want)
    return got.t().cpu().numpy()


@pytest.mark.parametrize("zero_share", [0.0, 0.5, 0.97, 1.0])
@pytest.mark.parametrize("B,S", [(1, 1), (7, 63), (33, 65), (130, 1000), (2048, 4096)])
def test_zero_runs_kernel_matches_plain(cuda, B, S, zero_share):
    check_zero_runs(*zero_run_case(B, S, zero_share, seed=B * S), cuda)


def test_zero_runs_cross_tiles_and_cap(cuda):
    """Runs across many 64-sample tiles: all-zero lanes of 70,000 samples
    (capped at 0xFFFF), and breaks every 300 samples."""
    errs, n = zero_run_case(5, 70000, 1.0, seed=1)
    n[1] = 66000
    errs[4, ::300] = 1
    got = check_zero_runs(errs, n, cuda)
    assert got.max() == 0xFFFF
    assert got[4, 1] == 298


@pytest.mark.parametrize("order", [0, 6])
def test_zero_runs_on_encoder_residuals(cuda, order):
    """The lookahead of the predictor's residuals at the encoder's shapes,
    and the whole device encode stage through its three kernels."""
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.cuda.enc_stages import (
        encode_stages_fused, predictor_errors_fused,
    )

    B, S = 2048, 4096
    sig, n, lp, rp = _enc_inputs(B, S, order, cuda)
    errs = predictor_errors_fused(sig, n, lp, S, max_order=_max_order(order))
    check_zero_runs(errs.cpu().numpy(), n.cpu().numpy(), cuda)
    before = _lib.LAUNCHES["zero_runs"]
    got = encode_stages_fused(sig, n, lp, rp, S, max_order=_max_order(order))
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["zero_runs"] == before + 1
    want = encode_stages_fused(sig, n, lp, rp, S, max_order=_max_order(order),
                               kernel="torch")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_refused_launch_raises_without_fallback(cuda, monkeypatch):
    """A refused launch of either kernel raises from the main path under
    ``kernel="auto"``; the plain versions are never reached."""
    from alacnet_tpu_torch.ops.cuda import _lib, enc_stages, epilogue, zero_runs
    from alacnet_tpu_torch.ops.frame_decode import FrameMetaArrays, decode_frames_packed

    lib = _lib.get_lib()

    class Refusing:
        def __getattr__(self, name):
            if name in ("alac_dec_epilogue", "alac_zero_runs"):
                return lambda *args: 9  # cudaErrorInvalidConfiguration
            return getattr(lib, name)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(_lib, "_lib", Refusing())
    monkeypatch.setattr(epilogue, "decode_epilogue_plain", no_plain)
    monkeypatch.setattr(zero_runs, "zero_run_lengths_sb", no_plain)
    fb, words = epilogue_batch(*epilogue_frames("stereo24-ub1"))
    w = torch.from_numpy(words.view(np.int32).copy()).to(cuda)
    with pytest.raises(RuntimeError, match="alac_dec_epilogue: CUDA error 9"):
        decode_frames_packed(w, FrameMetaArrays.pack_host(fb), EPI_S)
    sig, n, lp, rp = _enc_inputs(33, 255, 6, cuda)
    with pytest.raises(RuntimeError, match="alac_zero_runs: CUDA error 9"):
        enc_stages.encode_stages_fused(sig, n, lp, rp, 255, max_order=6)
    torch.cuda.synchronize()


@pytest.mark.parametrize("zero_share", [0.0, 0.9, 1.0])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 4096])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 2047, 2048])
def test_zero_runs_lane_and_sample_edges(cuda, B, S, zero_share):
    """The one-launch kernel at lane counts on both sides of its 16-byte
    rows (B % 4) and sample counts on both sides of a pass; the first
    lanes all zero (lane 0) and with n at S, 0, S + 5, -3 and S // 2."""
    check_zero_runs(*zero_run_case(B, S, zero_share, seed=B + S), cuda)


@pytest.mark.parametrize("strip", [8, 16])
def test_zero_runs_every_strip_across_passes(cuda, strip, monkeypatch):
    """Each strip width the C entry takes, forced: runs that cross the
    row groups of a pass and the passes (512 and 1,024 rows) of a block,
    breaks every 700 and every 3,000 samples, a misaligned plane (no
    16-byte rows), and lanes past the last full strip."""
    from alacnet_tpu_torch.ops.cuda import zero_runs

    monkeypatch.setattr(zero_runs, "pick_strip", lambda B, sms: strip)
    errs, n = zero_run_case(37, 9000, 1.0, seed=strip)
    errs[5, ::700] = 3
    errs[6, 2999::3000] = -1
    n[5:7] = 9000
    n[7] = 8999
    got = check_zero_runs(errs, n, cuda)
    assert got[5, 1] == 698 and got[6, 0] == 2998
    dev_errs = torch.from_numpy(errs.T.copy()).to(cuda)
    buf = torch.zeros(dev_errs.numel() + 1, dtype=torch.int32, device=cuda)
    buf[1:] = dev_errs.reshape(-1)
    view = buf[1:].view(dev_errs.shape)
    nn = torch.from_numpy(n).to(cuda)
    got = zero_runs.zero_run_lengths_fused(view, nn, kernel="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, zero_runs.zero_run_lengths_fused(view, nn, kernel="torch"))


def test_zero_runs_one_launch_no_scratch(cuda, monkeypatch):
    """One launch a call, and the wrapper allocates only its output."""
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.cuda.zero_runs import zero_run_lengths_fused

    errs, n = zero_run_case(2048, 4096, 0.5, seed=9)
    e = torch.from_numpy(errs.T.copy()).to(cuda)
    nn = torch.from_numpy(n).to(cuda)
    zero_run_lengths_fused(e, nn)
    seen = []
    monkeypatch.setattr(_lib, "launch", lambda name, *a: seen.append(name))
    allocated = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: allocated.append(a) or real_empty(*a, **k))
    zero_run_lengths_fused(e, nn)
    assert seen == ["alac_zero_runs"]
    assert allocated == [((4096, 2048),)]


# ---- the pair and quad merge (pair_merge) ----

#: Widths at the edges of the merge's three-word ladder.
PAIR_WIDTHS = (0, 31, 32, 33, 64, 81, 96)


def _mask_words(words, ws):
    """(c0, c1, c2) uint32 cut to each sample's width: the value right-
    aligned in the low ``ws`` bits of c0:c1:c2 (c2 the low word)."""
    w = ws.astype(np.int64)
    out = []
    for i, lo in enumerate((64, 32, 0)):
        nbits = np.clip(w - lo, 0, 32)
        keep = np.where(nbits >= 32, 0xFFFFFFFF, (1 << np.minimum(nbits, 31)) - 1)
        out.append((words[i].astype(np.int64) & keep).astype(np.uint32))
    return out


def pair_merge_case(B, S, seed, edge_share=0.05):
    """(c0, c1, c2 (B, S) uint32, ws (B, S) int8): chunk planes as the
    Rice stage writes them, widths mostly 0-24 with ``edge_share`` of
    them at the ladder's edges (PAIR_WIDTHS); lane 0 all width 0; lane 1
    (S >= 4) two adjacent 81-bit samples at an even index (a pair past
    96 bits: pws -1, fat, and a -1 pair poisoning its quad) and a 96-bit
    sample; lane 2's words unmasked (bits above the width set)."""
    rng = np.random.default_rng(seed)
    ws = rng.integers(0, 25, (B, S))
    edge = rng.random((B, S)) < edge_share
    ws[edge] = rng.choice(PAIR_WIDTHS, int(edge.sum()))
    ws[0] = 0
    if B > 1 and S >= 4:
        ws[1, 2:4] = 81
        ws[1, S - 1] = 96
    ws = ws.astype(np.int8)
    words = rng.integers(0, 1 << 32, (3, B, S), dtype=np.uint64).astype(np.uint32)
    c0, c1, c2 = _mask_words(words, ws)
    if B > 2:
        c0[2], c1[2], c2[2] = words[0, 2], words[1, 2], words[2, 2]
    return c0, c1, c2, ws


def pair_merge_edges():
    """One lane whose pairs are every (wa, wb) of PAIR_WIDTHS in turn,
    its quads every pair of those pairs; a second lane the same with
    the words unmasked."""
    combos = [(a, b) for a in PAIR_WIDTHS for b in PAIR_WIDTHS]
    ws = np.array([w for c in combos for w in c] * 2, np.int8).reshape(2, -1)
    rng = np.random.default_rng(len(combos))
    words = rng.integers(0, 1 << 32, (3,) + ws.shape, dtype=np.uint64).astype(np.uint32)
    c0, c1, c2 = _mask_words(words, ws)
    c0[1], c1[1], c2[1] = words[:, 1]
    return c0, c1, c2, ws


def pair_merge_planes(case, layout, dev):
    """The case's planes as (B, S) tensors on ``dev``: ``sample_major``
    the transposed views of (S, B) storage, as enc_rice returns them;
    ``lane_major`` contiguous rows; ``misaligned`` sample-major views one
    element into a larger buffer."""
    out = []
    for x in case:
        t = torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(dev)
        if layout == "lane_major":
            out.append(t)
            continue
        sb = t.t().contiguous()
        if layout == "misaligned":
            buf = torch.zeros(sb.numel() + 1, dtype=sb.dtype, device=dev)
            buf[1:] = sb.reshape(-1)
            sb = buf[1:].view(sb.shape)
        out.append(sb.t())
    return out


def check_pair_merge(planes, quads, dev):
    """``merge_pair_chunks_fused`` through the kernel (one launch,
    lane-major contiguous planes) and the plain version, bit for bit."""
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.cuda.pair_merge import merge_pair_chunks_fused

    before = _lib.LAUNCHES["pair_merge"]
    got = merge_pair_chunks_fused(*planes, quads=quads, kernel="cuda")
    _sync(got[0])
    assert _lib.LAUNCHES["pair_merge"] == before + 1
    want = merge_pair_chunks_fused(*planes, quads=quads, kernel="torch")
    assert len(got) == len(want) == (10 if quads else 5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
        assert g.is_contiguous()
    return got


@pytest.mark.parametrize("layout", ["sample_major", "lane_major", "misaligned"])
@pytest.mark.parametrize("quads", [False, True])
@pytest.mark.parametrize("B,S", [(1, 1), (3, 2), (5, 3), (33, 63), (31, 65), (130, 255),
                                 (129, 1001), (2048, 4096), (1920, 4096)])
def test_pair_merge_kernel_matches_plain(cuda, B, S, quads, layout):
    got = check_pair_merge(pair_merge_planes(pair_merge_case(B, S, seed=B + S), layout, cuda),
                           quads, cuda)
    if B > 1 and S >= 4:
        assert got[3][1, 1] == -1 and bool(got[4][1])
        if quads:
            assert bool(got[9][1])


@pytest.mark.parametrize("quads", [False, True])
def test_pair_merge_ladder_edges(cuda, quads):
    """Every pair of widths at the ladder's edges (a 96-bit B rolls A
    out of the words; a pair past 96 bits is -1), and the quads of them."""
    got = check_pair_merge(pair_merge_planes(pair_merge_edges(), "sample_major", cuda),
                           quads, cuda)
    assert bool(got[4][0]) and (got[3][0] == -1).any()


@pytest.mark.parametrize("quads", [False, True])
def test_pair_merge_through_encode_stages(cuda, quads):
    """``encode_stages`` with pairs (and quads) launches the merge once a
    call, its planes lane-major, equal to the plain route's."""
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.encode import encode_stages

    B, S = 512, 4096
    sig, n, lp, rp = _enc_inputs(B, S, 6, cuda)
    before = _lib.LAUNCHES["pair_merge"]
    got = encode_stages(sig, n, lp, rp, S, max_order=6, pairs=True, quads=quads)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["pair_merge"] == before + 1
    want = encode_stages(sig, n, lp, rp, S, max_order=6, pairs=True, quads=quads,
                         kernel="torch")
    assert len(got) == len(want) == (12 if quads else 7)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert all(p.is_contiguous() for p in got[:4])


def test_pair_merge_refused_launch_raises_without_fallback(cuda, monkeypatch):
    """A refused pair_merge launch raises from ``encode_stages`` under
    ``kernel="auto"``; the plain merge is never reached."""
    from alacnet_tpu_torch.ops.cuda import _lib, pair_merge
    from alacnet_tpu_torch.ops.encode import encode_stages

    lib = _lib.get_lib()

    class Refusing:
        def __getattr__(self, name):
            if name == "alac_pair_merge":
                return lambda *args: 9  # cudaErrorInvalidConfiguration
            return getattr(lib, name)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain merge ran on CUDA tensors")

    monkeypatch.setattr(_lib, "_lib", Refusing())
    monkeypatch.setattr(pair_merge, "merge_pair_chunks_plain", no_plain)
    sig, n, lp, rp = _enc_inputs(33, 255, 6, cuda)
    with pytest.raises(RuntimeError, match="alac_pair_merge: CUDA error 9"):
        encode_stages(sig, n, lp, rp, 255, max_order=6, pairs=True, quads=True)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Kernel 10, blob_words, and kernel 11, enc_prologue.  The case builders
# serve tests/test_torch_pack_rows.py and test_torch_enc_prologue.py too.
# ---------------------------------------------------------------------------


def prologue_case(F, S, bits, seed, mono_share=0.4):
    """(pcm (F, S, 2) int32, stereo (F,) bool) as the encoder uploads
    them: ``bits``-wide samples, every third frame at full scale with
    the channels opposite (|L - R| near 2**bits, the widest difference),
    channel 1 zero on mono frames."""
    rng = np.random.default_rng(seed)
    lim = 1 << (bits - 1)
    pcm = rng.integers(-lim, lim, (F, S, 2)).astype(np.int32)
    pcm[::3, :, 0] = lim - 1
    pcm[::3, :, 1] = -lim
    pcm[1::7] = 0
    stereo = rng.random(F) >= mono_share
    pcm[~stereo, :, 1] = 0
    return pcm, stereo


#: (lw, sh, ub8) of the card's prologue cases: none, the default, large
#: products, every shift past 16, a strip.
PROLOGUE_PARAMS = ((0, 0, 0), (1, 1, 0), (255, 31, 0), (200, 17, 0), (3, 5, 8), (0, 0, 8))


def check_prologue(pcm, stereo, lw, sh, ub8, wide, dev):
    from alacnet_tpu_torch.ops.cuda import enc_prologue as ep

    p, s = torch.from_numpy(pcm).to(dev), torch.from_numpy(stereo).to(dev)
    got = ep.encode_prologue_fused(p, s, lw, sh, ub8, wide, kernel="cuda")
    torch.cuda.synchronize()
    want = ep.encode_prologue_plain(p, s, lw, sh, ub8, wide)
    assert got.shape == (pcm.shape[1], 2 * pcm.shape[0]) and got.is_contiguous()
    assert torch.equal(got.t(), want), (lw, sh, ub8, wide)
    return got


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("F,S", [(1, 1), (3, 2), (4, 3), (31, 63), (32, 64), (33, 65),
                                 (37, 4095), (912, 4096)])
def test_enc_prologue_kernel_matches_plain(cuda, F, S, wide):
    """Kernel against plain version on tile edges: F not a multiple of
    32 (or of 4: the word-by-word stores), S not a multiple of 64 (or
    odd: the word-by-word loads), every parameter set."""
    pcm, stereo = prologue_case(F, S, 24 if wide else 16, F + S)
    for lw, sh, ub8 in PROLOGUE_PARAMS:
        check_prologue(pcm, stereo, lw, sh, ub8, wide, cuda)


@pytest.mark.parametrize("wide", [False, True])
def test_enc_prologue_every_shift(cuda, wide):
    """Shifts 0-31, and counts past the type's width (sign fill), with
    ``|cb| * lw`` past 2**31 on the wide lanes."""
    pcm, stereo = prologue_case(40, 130, 24 if wide else 16, 5)
    for sh in [*range(32), 32, 40, 63, 64, 200]:
        for lw in (1, 255):
            check_prologue(pcm, stereo, lw, sh, 0, wide, cuda)


@pytest.mark.parametrize("mono_share", [0.0, 1.0])
def test_enc_prologue_stereo_or_mono_only(cuda, mono_share):
    pcm, stereo = prologue_case(64, 256, 16, 9, mono_share=mono_share)
    for lw, sh, ub8 in PROLOGUE_PARAMS:
        check_prologue(pcm, stereo, lw, sh, ub8, False, cuda)


def test_enc_prologue_misaligned_pcm(cuda):
    """A PCM tensor that starts off a 16-byte boundary: the word-by-word
    loads."""
    from alacnet_tpu_torch.ops.cuda import enc_prologue as ep

    pcm, stereo = prologue_case(36, 128, 16, 3)
    buf = torch.zeros(pcm.size + 1, dtype=torch.int32, device=cuda)
    buf[1:] = torch.from_numpy(pcm.reshape(-1)).to(cuda)
    p = buf[1:].view(pcm.shape)
    assert p.data_ptr() % 16 != 0
    s = torch.from_numpy(stereo).to(cuda)
    got = ep.encode_prologue_fused(p, s, 1, 1, 0, False, kernel="cuda")
    assert torch.equal(got.t(), ep.encode_prologue_plain(p, s, 1, 1, 0, False))


def test_enc_prologue_feeds_the_predictor_without_a_copy(cuda, monkeypatch):
    """``encode_stages_pcm`` launches the prologue once a call, and the
    predictor's wrapper takes its output as it is: ``_sample_major``
    makes no copy of the signal."""
    from alacnet_tpu_torch.ops import encode as tenc
    from alacnet_tpu_torch.ops.cuda import _lib, enc_stages

    pcm, stereo = prologue_case(33, 255, 16, 4)
    F, S = stereo.shape[0], pcm.shape[1]
    sig, n, lp, rp = _enc_inputs(2 * F, S, 6, cuda)
    ptrs = []
    real = enc_stages._sample_major

    def spy(name, x, B, S):
        out = real(name, x, B, S)
        if name == "sig":
            ptrs.append((x.data_ptr(), out.data_ptr()))
        return out

    monkeypatch.setattr(enc_stages, "_sample_major", spy)
    _lib.reset_launches()
    got = tenc.encode_stages_pcm(torch.from_numpy(pcm).to(cuda),
                                 torch.from_numpy(stereo).to(cuda), n, lp, rp, S,
                                 max_order=6, lw=1, sh=1)
    want = tenc.encode_stages_pcm(torch.from_numpy(pcm).to(cuda),
                                  torch.from_numpy(stereo).to(cuda), n, lp, rp, S,
                                  max_order=6, lw=1, sh=1, kernel="torch")
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["enc_prologue"] == 1
    assert len(ptrs) == 1 and ptrs[0][0] == ptrs[0][1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("max_w", [0, 256, 4096])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 6, 7, 8, 4097, 4098, 4099, 4100,
                               65947392 // 64 + 3])
def test_blob_words_kernel_matches_plain(cuda, n, max_w):
    """Every ``n % 4`` (the tail word) and every ``m % 4`` (the quad
    that holds word m reads word by word), the empty blob, blobs under
    one word, and wide padding."""
    from alacnet_tpu_torch.ops.cuda import pack_rows as pr

    blob = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    w32, tail, nq = pr.host_le_words(blob, max_w)
    x = torch.from_numpy(w32.view(np.int32).copy()).to(cuda)
    got = pr.blob_words_fused(x, tail, nq, kernel="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, pr.blob_words_plain(x, tail, nq))
    assert torch.equal(pr.blob_words(blob, cuda, max_w=max_w), got)


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_blob_words_misaligned_word_base(cuda, shift):
    """Words that start off a 16-byte boundary: the word-by-word loads."""
    from alacnet_tpu_torch.ops.cuda import pack_rows as pr

    blob = np.random.default_rng(shift).integers(0, 256, 10003, dtype=np.uint8)
    w32, tail, nq = pr.host_le_words(blob, 512)
    buf = torch.zeros(w32.size + shift, dtype=torch.int32, device=cuda)
    buf[shift:] = torch.from_numpy(w32.view(np.int32).copy()).to(cuda)
    x = buf[shift:]
    assert x.data_ptr() % 16 != 0
    got = pr.blob_words_fused(x, tail, nq, kernel="cuda")
    assert torch.equal(got, pr.blob_words_plain(x, tail, nq))


def test_decode_blob_launches_blob_words_once(cuda):
    """One ``blob_words`` launch a ``decode_blob`` call; the plain route
    (``DecodeConfig(kernel="torch")``) launches none and decodes the
    same PCM."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.ops.cuda import _lib

    _, _, streams = _pooled_smoke(2)
    _lib.reset_launches()
    got = at.decode_streams(streams, device="cuda")
    assert _lib.LAUNCHES["blob_words"] == 1
    _, _, streams = _pooled_smoke(2)
    _lib.reset_launches()
    want = at.decode_streams(streams, config=at.DecodeConfig(device="cuda", kernel="torch"))
    assert _lib.LAUNCHES["blob_words"] == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.pcm, w.pcm)


def test_blob_words_and_prologue_refused_launch_raise_without_fallback(cuda, monkeypatch):
    """A refused launch of either kernel raises from its caller under
    ``kernel="auto"``; the plain versions are never reached."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.ops import encode as tenc
    from alacnet_tpu_torch.ops.cuda import _lib, enc_prologue, pack_rows

    lib = _lib.get_lib()

    class Refusing:
        def __getattr__(self, name):
            if name in ("alac_blob_words", "alac_enc_prologue"):
                return lambda *args: 9  # cudaErrorInvalidConfiguration
            return getattr(lib, name)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(_lib, "_lib", Refusing())
    monkeypatch.setattr(pack_rows, "blob_words_plain", no_plain)
    monkeypatch.setattr(enc_prologue, "encode_prologue_plain", no_plain)
    _, _, streams = _pooled_smoke(1)
    with pytest.raises(RuntimeError, match="alac_blob_words: CUDA error 9"):
        at.decode_streams(streams, device="cuda")
    pcm, stereo = prologue_case(8, 64, 16, 0)
    _, n, lp, rp = _enc_inputs(16, 64, 6, cuda)
    with pytest.raises(RuntimeError, match="alac_enc_prologue: CUDA error 9"):
        tenc.encode_stages_pcm(torch.from_numpy(pcm).to(cuda),
                               torch.from_numpy(stereo).to(cuda), n, lp, rp, 64,
                               max_order=6, lw=1, sh=1)
    torch.cuda.synchronize()


# -- frames of 3-8 channels: the element chain ---------------------------------
#
# The cases, shared with tests/test_torch_multichannel.py (the CPU
# side): a frame of C channels is its channel map's elements
# (``cookie.CHANNEL_ELEMENTS``), each written by the port's host encoder's
# own element writers into one bit stream, then END.

MC_S = 256


def mc_pcm(n, C, bits, seed):
    """(n, C) int32: a partial a channel plus noise; the last channel of
    a 5.1-8 map (the LFE) a low partial only."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    amp = 1 << (bits - 3)
    x = np.sin(t * (0.004 + 0.0023 * np.arange(C)) + rng.uniform(0, 6, C)) * amp
    x = x + rng.integers(-(1 << (bits - 10)), 1 << (bits - 10), (n, C))
    if C >= 6:
        x[:, -1] = np.sin(t[:, 0] * 0.001) * amp
    return x.astype(np.int32)


def mc_frame(pcm, params, orders=8, ub=0, raw=(), tags=None, aux=None, end=True,
             counts=None):
    """One frame of ``pcm`` ((n, C) int32) as its map's elements.

    ``orders``: one predictor order, or one an element; ``raw``: the
    elements written uncompressed (escape); ``tags``: the tag of each
    element in place of the map's; ``aux``: {element: [(tag, body)]}
    DSE/FIL-style elements written before it (``len(kinds)``: before
    END), each body a list of (value, width) fields, width None for
    zeros up to the next byte; ``end``: write the END tag; ``counts``:
    each element's sample count written in its header in place of n."""
    from alacnet_tpu_torch.codec.bitwriter import BitWriter
    from alacnet_tpu_torch.codec.cookie import CHANNEL_ELEMENTS, ID_CPE, ID_END, ID_SCE
    from alacnet_tpu_torch.codec.encoder import AlacEncoder, EncoderConfig

    n, C = pcm.shape
    kinds = CHANNEL_ELEMENTS[C]
    w = BitWriter()
    instance = {1: 0, 2: 0}
    c = 0
    aux = aux or {}
    for k, kind in enumerate(kinds):
        _mc_aux(w, aux.get(k, ()))
        order = orders if np.isscalar(orders) else orders[k]
        enc = AlacEncoder(params, EncoderConfig(order=order, uncompressed_bytes=ub))
        tag = (ID_CPE if kind == 2 else ID_SCE) if tags is None else tags[k]
        w.write(tag, 3)
        w.write(instance[kind], 4)
        instance[kind] += 1
        w.write(0, 12)
        count = n if counts is None else counts[k]
        hassize = int(count != params.max_samples_per_frame)
        is_raw = k in raw
        w.write(hassize, 1)
        w.write(0 if is_raw else ub, 2)
        w.write(int(is_raw), 1)
        if hassize:
            w.write(count, 32)
        chans = pcm[:, c : c + kind]
        if is_raw:
            enc._write_uncompressed(w, chans)
        elif kind == 1:
            enc._write_mono_compressed(w, chans[:, 0], ub)
        else:
            enc._write_stereo_compressed(w, chans, ub)
        c += kind
    _mc_aux(w, aux.get(len(kinds), ()))
    if end:
        w.write(ID_END, 3)
    return w.getvalue()


def _mc_aux(w, elements):
    for tag, body in elements:
        w.write(tag, 3)
        for v, width in body:
            w.write(v, (8 - w.bitpos % 8) % 8 if width is None else width)


def mc_file(C, bits=24, lengths=(MC_S, MC_S, 100), seed=0, ub=None, frame_kw=None):
    """An .m4a of C channels (the muxer writes the ``chan`` record) ->
    (bytes, source PCM, payloads, params).  ``frame_kw``: {frame index:
    mc_frame keywords}."""
    from alacnet_tpu_torch.codec.cookie import default_cookie
    from alacnet_tpu_torch.container import mux

    params = default_cookie(48000, bits, C, MC_S)
    ub = (1 if bits == 24 else 0) if ub is None else ub
    pcms, frames = [], []
    for i, n in enumerate(lengths):
        pcm = mc_pcm(n, C, bits, seed * 1000 + i)
        pcms.append(pcm)
        frames.append(mc_frame(pcm, params, ub=ub, **(frame_kw or {}).get(i, {})))
    f = io.BytesIO()
    mux.write_m4a(f, params, frames, list(lengths))
    return f.getvalue(), np.concatenate(pcms), frames, params


def mc_library(seed=0):
    """Four 5.1 files, a 7.1 and a 3.0 file: every map's shape in one
    pool, escapes and order-31 elements among them, and later elements
    whose orders are above every element 0's (the wide launch)."""
    files = [mc_file(6, 24, seed=seed), mc_file(6, 16, seed=seed + 1),
             mc_file(6, 24, seed=seed + 2,
                     frame_kw={0: {"raw": (2,)}, 1: {"orders": (31, 4, 8, 31)}}),
             mc_file(8, 24, seed=seed + 3), mc_file(3, 16, seed=seed + 4),
             mc_file(6, 16, seed=seed + 5,
                     frame_kw={0: {"orders": (4, 12, 16, 6)}, 1: {"orders": (8, 4, 31, 16)}})]
    return files


def _mc_stereo_files():
    import alacnet_tpu_torch as at

    out = []
    for ch, bits in ((2, 16), (1, 24)):
        pcm = mc_pcm(700, ch, bits, 7 + ch)
        f = io.BytesIO()
        at.encode_m4a(f, pcm, 48000, bits, max_samples_per_frame=MC_S)
        out.append((f.getvalue(), pcm))
    return out


def _checked_elem_head(monkeypatch, seen):
    """Route ``frame_decode``'s header kernel through a wrapper that runs
    the kernel and the plain version on the same inputs and compares."""
    from alacnet_tpu_torch.ops import frame_decode as fd
    from alacnet_tpu_torch.ops.cuda import elem_head as eh

    real = eh.elem_head

    def both(*a, **kw):
        got = real(*a, **dict(kw, kernel="cuda"))
        want = real(*a, **dict(kw, kernel="torch"))
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g.cpu(), w.cpu()), f"elem_head pass {a[6]}"
        seen.append(a[6])  # the element
        return got

    monkeypatch.setattr(fd.elem_head, "elem_head", both)


def test_elem_head_kernel_matches_plain(cuda, monkeypatch):
    """Every header pass of a pooled decode of every map's shape, DSE and
    FIL elements, escapes and order 31: kernel and plain version equal,
    and the PCM equals the source."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.codec.cookie import ID_DSE, ID_FIL

    files = mc_library(1)
    aux = {1: [(ID_DSE, [(3, 4), (1, 1), (255, 8), (2, 8), (0, None)] + [(0xA5, 8)] * 257)],
           4: [(ID_FIL, [(15, 4), (3, 8)] + [(0, 8)] * 17)]}
    files.append(mc_file(6, 24, seed=9, frame_kw={0: {"aux": aux}}))
    seen = []
    _checked_elem_head(monkeypatch, seen)
    got = at.decode_streams([io.BytesIO(f[0]) for f in files], device="cuda")
    assert seen and max(seen) == 5
    for g, f in zip(got, files):
        np.testing.assert_array_equal(g.pcm, f[1])


@pytest.mark.parametrize("layout", [(84, 87, 92), (83, 86, 92), (83, 87, 93)])
def test_elem_head_refuses_another_layout(cuda, layout):
    """The header kernel's C entry refuses a packed layout other than its
    own (``elem_head.N_PACKED``, ``N_CHAINED``, ``ROWS``) and takes its
    own."""
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.ops.cuda import elem_head as eh

    assert (eh.N_PACKED, eh.N_CHAINED, eh.ROWS) == (83, 87, 92)

    def launch(sizes):
        _lib.launch("alac_elem_head", cuda, None, 0, 1, None, None, None, None, None, 1,
                    4096, 8, *sizes, None, None, None)

    launch((eh.N_PACKED, eh.N_CHAINED, eh.ROWS))
    with pytest.raises(RuntimeError, match="alac_elem_head: CUDA error 1"):
        launch(layout)
    torch.cuda.synchronize()


def test_multichannel_on_card_matches_plain_route_and_mesh(cuda):
    """A pool of 5.1, 7.1, 3-channel, stereo and mono files on the card,
    through the kernels, the plain route and a two-shard mesh on one
    card: all equal to the source."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.parallel.mesh import Mesh

    files = [(f[0], f[1]) for f in mc_library(2)] + _mc_stereo_files()
    runs = {
        "kernel": at.decode_streams([io.BytesIO(d) for d, _ in files], device="cuda"),
        "plain": at.decode_streams([io.BytesIO(d) for d, _ in files],
                                   config=at.DecodeConfig(device="cuda", kernel="torch")),
        "mesh": at.decode_streams([io.BytesIO(d) for d, _ in files],
                                  mesh=Mesh(["cuda:0", "cuda:0"])),
    }
    for name, got in runs.items():
        for g, (_, pcm) in zip(got, files):
            np.testing.assert_array_equal(g.pcm, pcm.astype(g.pcm.dtype), err_msg=name)


def test_multichannel_mesh_over_every_card(cards):
    """The element chain under a mesh of every card equals one card."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.parallel.mesh import Mesh

    files = mc_library(3)
    mesh = Mesh([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    got = at.decode_streams([io.BytesIO(f[0]) for f in files], mesh=mesh)
    for g, f in zip(got, files):
        np.testing.assert_array_equal(g.pcm, f[1].astype(g.pcm.dtype))


def test_stereo_pool_launches_unchanged(cuda):
    """A stereo pool's ``decode_blob`` launches exactly what it launched
    before the element chain (no header kernel, one epilogue, one
    rice_lpc a channel a batch); a 5.1 pool adds the chain's passes."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.ops.cuda import _lib

    _, _, streams = _pooled_smoke(2)
    _lib.reset_launches()
    at.decode_streams(streams, device="cuda")
    torch.cuda.synchronize()
    # the parent commit's count for this pool (two batches)
    assert dict(_lib.LAUNCHES) == {"blob_words": 1, "pack_rows": 2, "rice_lpc": 4,
                                   "bulk_bits": 2, "dec_epilogue": 2}
    _lib.reset_launches()
    at.decode_streams([io.BytesIO(mc_file(6, 24)[0])], device="cuda")
    torch.cuda.synchronize()
    # one batch: element 0 (bulk_bits, rice_lpc A, epilogue), then three
    # chained elements (header, bulk_bits, rice_lpc A [+ B] at element
    # 0's order bucket and again at the widest, epilogue) and the END pass
    assert dict(_lib.LAUNCHES) == {"blob_words": 1, "pack_rows": 1, "elem_head": 4,
                                   "bulk_bits": 4, "rice_lpc": 11, "dec_epilogue": 4}


def check_dec_epilogue_wide(planes, cols, S, emit16, C, dev, seed=0):
    """The C-channel epilogue through the kernel and the plain version,
    bit for bit: the first element's call (every channel of each row),
    then a later element's into that output (its channels at each lane's
    offset, lanes at a negative offset untouched)."""
    from alacnet_tpu_torch.ops.cuda.epilogue import decode_epilogue

    p = _epilogue_planes(planes, "sample_major", dev)
    c = [torch.from_numpy(cols[k]).to(dev) for k in EPILOGUE_COLUMNS]
    B = c[0].shape[0]
    got = decode_epilogue(*p, *c, S, emit16=emit16, kernel="cuda", channels=C)
    want = decode_epilogue(*p, *c, S, emit16=emit16, kernel="torch", channels=C)
    assert got.shape == (B, S, C) and torch.equal(got, want)
    coff = np.random.default_rng(seed).integers(-1, C - 1, B)
    coff = np.where(cols["is_stereo"], np.minimum(coff, C - 2), coff).astype(np.int32)
    coff = torch.from_numpy(coff).to(dev)
    got = decode_epilogue(*p, *c, S, emit16=emit16, kernel="cuda", channels=C, out=got,
                          channel_offset=coff)
    want = decode_epilogue(*p, *c, S, emit16=emit16, kernel="torch", channels=C, out=want,
                           channel_offset=coff)
    assert torch.equal(got, want)


@pytest.mark.parametrize("C", [3, 6, 8])
@pytest.mark.parametrize("emit16", [False, True])
@pytest.mark.parametrize("B,S", [(1, 1), (70, 257), (1030, 64)])
def test_dec_epilogue_wide_matches_plain(cuda, B, S, C, emit16):
    planes, cols = epilogue_synthetic(B, S, seed=B + C)
    cols["n"] = np.clip(cols["n"], 0, S).astype(np.int32)
    check_dec_epilogue_wide(planes, cols, S, emit16, C, cuda, seed=S)


def _track16(frames, seed):
    """A 16-bit stereo .m4a of ``frames`` 4096-sample frames, the last one
    partial -> (bytes, source PCM)."""
    import alacnet_tpu_torch as at

    pcm = mc_pcm(4096 * (frames - 1) + 100, 2, 16, seed)
    f = io.BytesIO()
    at.encode_m4a(f, pcm, 44100, 16)
    return f.getvalue(), pcm


def _decode_counted(streams, **kw):
    """``decode_streams`` and ``GLOBAL_STATS``'s snapshot of that call."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.utils.observability import GLOBAL_STATS

    GLOBAL_STATS.reset()
    got = at.decode_streams(streams, **kw)
    torch.cuda.synchronize()
    snap = GLOBAL_STATS.snapshot()
    GLOBAL_STATS.reset()
    return got, snap


@pytest.mark.parametrize("frames", [3, 65, 1030])
def test_padded_16bit_track_launches_the_int16_epilogue(cuda, monkeypatch, frames):
    """A one-track 16-bit ``decode_streams`` whose batches are all padded
    launches only ``epilogue_kernel<int16_t>`` (emit16, two channels),
    ships half the bytes of ``emit16=False`` and equals the plain route
    and the source."""
    import collections

    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.batch import _pool
    from alacnet_tpu_torch.ops.cuda import _lib
    from alacnet_tpu_torch.parallel import pipeline as P

    data, pcm = _track16(frames, frames)
    _, _, pooled, params = _pool([io.BytesIO(data)])
    lanes = [hi - lo for lo, hi in P.plan_blob_batches(*pooled, params, 4096, True)[2]]
    assert all(b not in P.BATCH_BUCKETS for b in lanes)
    epilogues = collections.Counter()
    orig = _lib.launch

    def rec(name, device, *args):
        if name == "alac_dec_epilogue":
            epilogues[args[-4:-2]] += 1  # (emit16, channels)
        return orig(name, device, *args)

    monkeypatch.setattr(_lib, "launch", rec)
    _lib.reset_launches()
    (got,), snap = _decode_counted([io.BytesIO(data)], device="cuda")
    assert dict(epilogues) == {(1, 2): len(lanes)} and _lib.LAUNCHES["dec_epilogue"] == len(lanes)
    assert snap["int16_batches"] == snap["dispatches"] == len(lanes)
    assert snap["assembly_views"] == 1
    assert got.pcm.dtype == np.int16
    np.testing.assert_array_equal(got.pcm, pcm)
    (plain,), _ = _decode_counted([io.BytesIO(data)],
                                  config=at.DecodeConfig(device="cuda", kernel="torch"))
    assert plain.pcm.dtype == np.int16
    np.testing.assert_array_equal(plain.pcm, got.pcm)
    (wide,), off = _decode_counted([io.BytesIO(data)],
                                   config=at.DecodeConfig(device="cuda", emit16=False))
    np.testing.assert_array_equal(wide.pcm, got.pcm)
    assert off["int16_batches"] == 0
    assert off["pcm_bytes_back"] == 2 * snap["pcm_bytes_back"] == frames * 4096 * 2 * 4


def test_padded_16bit_pool_mesh_over_every_card(cards):
    """Eight 16-bit tracks over a mesh of every card: int16 batches
    throughout, each file equal to one card's and to its source."""
    from alacnet_tpu_torch.parallel.mesh import Mesh

    tracks = [_track16(k, 20 + k) for k in (1, 3, 9, 65, 70, 130, 200, 300)]
    mesh = Mesh([f"cuda:{i}" for i in range(len(cards))])
    meshed, snap = _decode_counted([io.BytesIO(d) for d, _ in tracks], mesh=mesh)
    one, one_snap = _decode_counted([io.BytesIO(d) for d, _ in tracks], device="cuda")
    assert snap["int16_batches"] == snap["dispatches"] == one_snap["int16_batches"]
    for m, o, (_, pcm) in zip(meshed, one, tracks):
        assert m.pcm.dtype == o.pcm.dtype == np.int16
        np.testing.assert_array_equal(m.pcm, pcm)
        np.testing.assert_array_equal(o.pcm, pcm)
