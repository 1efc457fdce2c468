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


def _launch_streams(monkeypatch):
    """Record (kernel, raw stream handle) of every launch from now on."""
    import collections

    from alacnet_tpu_torch.ops.cuda import _lib

    seen = collections.Counter()
    orig = _lib.launch

    def rec(name, device, *args):
        index = device.index if device.index is not None else torch.cuda.current_device()
        seen[(name.removeprefix("alac_"), torch._C._cuda_getCurrentRawStream(index))] += 1
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
    on both shard streams (and on no other), and the encode kernels on
    both too."""
    import alacnet_tpu_torch as at
    from alacnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(["cuda:0", "cuda:0"])
    handles = [s.cuda_stream for s in mesh.streams]
    assert len(set(handles)) == 2
    seen = _launch_streams(monkeypatch)
    _, names, streams = _pooled_smoke(MESH_COPIES)
    decoded = at.decode_streams(streams, mesh=mesh)
    for k in ("pack_rows", "rice_lpc", "bulk_bits"):
        assert all(seen[(k, h)] > 0 for h in handles), (k, seen)
    assert {h for _, h in seen} == set(handles)
    seen.clear()
    music = decoded[names.index("music.m4a") * MESH_COPIES]
    at.encode_files([music.pcm] * 3, [io.BytesIO() for _ in range(3)],
                    music.sample_rate, 16, mesh=mesh)
    for k in ("enc_pred", "enc_rice"):
        assert all(seen[(k, h)] > 0 for h in handles), (k, seen)


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
