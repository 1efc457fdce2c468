"""A plain NumPy ALAC frame encoder, frozen for the benchmark.

The same frame logic as the port's host ``AlacEncoder``
(``alacnet_tpu_torch/codec/encoder.py``: ``_predictor_errors``,
``_RiceEncoder``, ``levinson_coefs_batch`` and the frame layout of
``_encode_frame_native``), written once more so that the benchmark's
inputs and its encode reference stay fixed whatever later changes the
port.  It imports nothing of the port.

The frame logic is a recurrence along the samples of one channel (the
adaptive FIR and the Rice history), so it runs one sample at a time;
every channel of every frame is a lane, and each step runs over all
lanes at once.  A pool of a few hundred frames then costs about as much
as one frame would.

Output: the coded bytes of each frame and, per lane, the bits of its
Rice section (the benchmark's roofline counts read them).
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Unary run length cap before escape coding (the decoder's threshold).
RICE_THRESHOLD = 8
#: Apple's standard cookie tuning (history mult, initial history, k modifier).
HISTORY_MULT = 0x28
INITIAL_HISTORY = 0x0A
KMODIFIER = 0x0E


@dataclasses.dataclass(frozen=True)
class FrameCoding:
    """How frames are coded (the port's ``EncoderConfig`` fields)."""

    sample_size: int = 16
    max_samples_per_frame: int = 4096
    quant: int = 9
    rice_modifier: int = 4
    interlacing_shift: int = 1
    interlacing_leftweight: int = 1
    uncompressed_bytes: int = 0
    levinson_window: int = 1024


@dataclasses.dataclass
class Coded:
    """Frames coded by :func:`encode_frames`."""

    payloads: list  # bytes per frame
    rice_bits: np.ndarray  # (F, C) int64 bits of each channel's Rice section
    orders: np.ndarray  # (F, C) int64 predictor order of each channel


def wrap32(x):
    """Two's-complement int32 wrap of int64 values."""
    return ((np.asarray(x, np.int64) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def center(x, bits: int):
    """Reduce mod 2**bits into [-2**(bits-1), 2**(bits-1))."""
    m = 1 << bits
    x = np.asarray(x, np.int64) & (m - 1)
    return np.where(x >= (m >> 1), x - m, x)


def clz32(x):
    """Leading zeros of the int32 word; 40 for zero, as the reference's
    byte ladder gives it."""
    u = np.asarray(x, np.int64) & 0xFFFFFFFF
    bitlen = np.frexp(u.astype(np.float64))[1].astype(np.int64)
    return np.where(u == 0, 40, 32 - bitlen)


def levinson(sig: np.ndarray, ns: np.ndarray, order: int, quant: int) -> np.ndarray:
    """(B, order) int32 LPC coefficients by Levinson-Durbin over each lane's
    first ``ns`` samples (``sig`` zero past them).  The autocorrelation is
    summed exactly in int64 (the port's float64 sums of these products are
    exact too), then the recursion runs as the port's does."""
    sig = np.asarray(sig, np.int64)
    B, S = sig.shape
    ns = np.asarray(ns, np.int64)
    if order == 0:
        return np.zeros((B, 0), np.int32)
    r = np.empty((order + 1, B))
    for k in range(order + 1):
        r[k] = 0.0 if k >= S else np.einsum("bs,bs->b", sig[:, : S - k], sig[:, k:])
    dead = (ns <= order + 1) | (r[0] <= 0)
    r[0] = np.where(r[0] <= 0, 1.0, r[0] * (1.0 + 1e-9))
    a = np.zeros((order + 1, B))
    a[0] = 1.0
    err = r[0].copy()
    live = np.ones(B, bool)
    for m in range(1, order + 1):
        acc = r[m] + np.einsum("kb,kb->b", a[1:m], r[1:m][::-1])
        k = np.where(live, -acc / np.where(live, err, 1.0), 0.0)
        a[1:m] = np.where(live, a[1:m] + k * a[m - 1 : 0 : -1], a[1:m])
        a[m] = k
        err = err * (1.0 - k * k)
        live = live & (err > 0)
    coefs = np.round(-a[1 : order + 1].T * (1 << quant))
    coefs = np.clip(coefs, -32768, 32767).astype(np.int32)
    return np.where(dead[:, None], np.zeros_like(coefs), coefs)


def predictor_errors(sig: np.ndarray, coefs: np.ndarray, order: int, quant: int,
                     rss: int) -> np.ndarray:
    """(L, S) residuals whose decode gives back ``sig`` (L lanes of one
    order), mirroring the decoder's adaptive FIR; values past a lane's own
    length are computed and never read.  The arithmetic is int32 and
    wraps as the decoder's does; a residual is its value mod 2**rss, which
    the wrap leaves alone."""
    sig = np.asarray(sig, np.int64)
    L, S = sig.shape
    err = np.zeros((L, S), np.int64)
    if S == 0:
        return err
    err[:, 0] = sig[:, 0]
    if order == 0:
        return sig.copy()
    if order == 31:
        err[:, 1:] = center(sig[:, 1:] - sig[:, :-1], rss)
        return err
    top = min(order, S - 1)
    err[:, 1 : top + 1] = center(sig[:, 1 : top + 1] - sig[:, :top], rss)
    st = np.ascontiguousarray(sig.T.astype(np.int32))  # (S, L)
    c = np.ascontiguousarray(np.asarray(coefs, np.int64).T.astype(np.int32))  # (order, L)
    out = np.zeros((S, L), np.int32)
    half = np.int32(1 << (quant - 1))
    for i in range(order + 1, S):
        base = st[i - order - 1]
        d = st[i - order : i][::-1] - base  # d[j] = sig[i-1-j] - base
        total = (d * c).sum(axis=0, dtype=np.int32)
        pred = (half + total) >> quant
        e = st[i] - pred - base
        out[i] = e
        e = center(e, rss).astype(np.int32)
        pos = e > 0
        neg = e < 0
        if not (pos.any() or neg.any()):
            continue
        ev = e
        val = -d  # sig[base] - sig[base + order - pn], per pn
        s = np.sign(val) * np.where(pos, 1, -1).astype(np.int32)
        step = (val * s) >> quant
        for pn in range(order - 1, -1, -1):
            act = (pos & (ev > 0)) | (neg & (ev < 0))
            if not act.any():
                break
            c[pn] -= s[pn] * act
            ev = ev - step[pn] * np.int32(order - pn) * act
    err[:, order + 1 :] = center(out[order + 1 :].T, rss)
    return err


def _emit(raw, rss, k, mask):
    """One entropy symbol as two (value, width) fields, such that the
    decoder's value read with (rss, k, mask) returns ``raw``."""
    m = ((np.int64(1) << k) - 1) & mask
    ok = m > 0
    msafe = np.where(ok, m, 1)
    q = np.where(ok, raw // msafe, RICE_THRESHOLD + 1)
    r = np.where(ok, raw % msafe, 0)
    esc = q > RICE_THRESHOLD
    qq = np.minimum(q, RICE_THRESHOLD)
    va = np.where(esc, (1 << (RICE_THRESHOLD + 1)) - 1, ((np.int64(1) << qq) - 1) << 1)
    wa = np.where(esc, RICE_THRESHOLD + 1, qq + 1)
    vb = np.where(esc, raw, np.where(r == 0, 0, r + 1))
    wb = np.where(esc, rss, np.where(r == 0, k - 1, k))
    return va, wa, vb, wb


def rice_fields(err: np.ndarray, n: np.ndarray, rss: int, rice_modifier: int):
    """Rice-code each lane's first ``n`` residuals.  Returns (values,
    widths), each (L, T, 4): per step a value symbol (two fields) and the
    zero-run symbol after it (two fields, width 0 where none)."""
    err = np.asarray(err, np.int64)
    L, S = err.shape
    n = np.asarray(n, np.int64)
    cols = np.arange(S)
    # zeros[l, i]: the run of zero residuals starting at i, within n
    stop = np.where((err != 0) | (cols[None, :] >= n[:, None]), cols[None, :], S)
    nxt = np.minimum.accumulate(stop[:, ::-1], axis=1)[:, ::-1]
    zeros = np.concatenate([nxt - cols[None, :], np.zeros((L, 1), np.int64)], axis=1)
    mult = rice_modifier * (HISTORY_MULT // 4)
    kmask = (1 << KMODIFIER) - 1
    hist = np.full(L, INITIAL_HISTORY, np.int64)
    sm = np.zeros(L, np.int64)
    pc = np.zeros(L, np.int64)
    lanes = np.arange(L)
    vals = np.zeros((L, max(S, 1), 4), np.int64)
    wids = np.zeros((L, max(S, 1), 4), np.int64)
    t = 0
    while True:
        act = pc < n
        if not act.any():
            break
        x = err[lanes, np.minimum(pc, S - 1)]
        dv = np.where(x > 0, 2 * x, np.where(x < 0, -2 * x - 1, 0))
        raw = dv - sm
        ik = 31 - KMODIFIER - clz32(wrap32((hist >> 9) + 3))
        k = np.where(ik < 0, ik + KMODIFIER, KMODIFIER)
        va, wa, vb, wb = _emit(np.maximum(raw, 0), rss, k, 0xFFFFFFFF)
        hist = np.where(
            dv > 0xFFFF, 0xFFFF,
            wrap32(hist + wrap32(dv * mult) - (wrap32(hist * mult) >> 9)),
        )
        run_here = act & (hist < 128) & (pc + 1 < n)
        kz = clz32(hist) + (hist + 16) // 64 - 24
        run = np.minimum(zeros[lanes, np.minimum(pc + 1, S)], 0xFFFF)
        run = np.where(run_here, run, 0)
        vc, wc, vd, wd = _emit(run, 16, np.where(run_here, kz, 1), kmask)
        on = act.astype(np.int64)
        rh = run_here.astype(np.int64)
        vals[:, t] = np.stack([va * on, vb * on, vc * rh, vd * rh], axis=1)
        wids[:, t] = np.stack([wa * on, wb * on, wc * rh, wd * rh], axis=1)
        sm = rh
        hist = np.where(run_here, 0, hist)
        pc = np.where(act, pc + run + 1, pc)
        t += 1
    if (wids < 0).any() or (wids > 32).any():
        raise AssertionError("a field wider than 32 bits")
    return vals[:, :t], wids[:, :t]


def pack_fields(frame_of, offset, value, width, frame_bits) -> list:
    """Bytes of each frame from its bit fields: ``frame_of`` the frame of
    each field, ``offset`` its first bit within the frame (MSB first),
    ``width`` at most 32.  Fields never overlap, so the sum of their bytes
    is their OR."""
    frame_bytes = (np.asarray(frame_bits, np.int64) + 7) // 8
    base = np.concatenate([[0], np.cumsum(frame_bytes)])
    keep = width > 0
    frame_of, offset = frame_of[keep], offset[keep]
    value, width = value[keep], width[keep]
    bit = base[frame_of] * 8 + offset
    byte = bit >> 3
    sh = bit & 7
    v = (value & ((np.int64(1) << width) - 1)) << (40 - sh - width)
    out = np.zeros(int(base[-1]) + 5)
    for j in range(5):
        out += np.bincount(byte + j, weights=((v >> (32 - 8 * j)) & 0xFF).astype(np.float64),
                           minlength=out.size)[: out.size]
    blob = out.astype(np.uint8).tobytes()
    return [blob[base[f] : base[f + 1]] for f in range(len(frame_bytes))]


def _predict(lanes, lane_n, lane_order, coding: FrameCoding, rss: int):
    """Each lane's Levinson coefficients and residuals at its own order."""
    L, S = lanes.shape
    coefs = np.zeros((L, 31), np.int64)
    err = np.zeros((L, S), np.int64)
    for order in np.unique(lane_order):
        sel = np.flatnonzero(lane_order == order)
        order = int(order)
        if order not in (0, 31):
            w = coding.levinson_window or S
            win = lanes[sel, :w] * (np.arange(min(w, S))[None, :] < lane_n[sel, None])
            coefs[sel, :order] = levinson(win, np.minimum(lane_n[sel], w), order, coding.quant)
        err[sel] = predictor_errors(lanes[sel], coefs[sel, :order], order, coding.quant, rss)
    return coefs, err


def _coef_bits(order):
    return 16 * np.where(np.asarray(order) == 31, 0, order)


def encode_frames(pcm: np.ndarray, n: np.ndarray, orders, coding: FrameCoding) -> Coded:
    """Code frames of one format.  ``pcm``: (F, S, C) int PCM, C 1 or 2,
    zero past each frame's ``n[f]`` samples.  ``orders``: the predictor
    order of each frame, (F,) or (F, C) one a channel; or a tuple of
    candidate orders, of which each channel of each frame is coded at the
    one that costs the fewest bits (Rice section and coefficients; the
    lower order on a tie), as Apple's reference encoder chooses between
    its orders.  Returns the payloads the port's host encoder writes for
    the same samples, orders and settings."""
    pcm = np.asarray(pcm, np.int64)
    F, S, C = pcm.shape
    n = np.asarray(n, np.int64)
    if C not in (1, 2):
        raise ValueError(f"1 or 2 channels, got {C}")
    ub = coding.uncompressed_bytes
    rss = coding.sample_size - 8 * ub + (1 if C == 2 else 0)
    shift = 8 * ub
    hi = pcm >> shift
    extra = pcm & ((1 << shift) - 1)
    if C == 2 and coding.interlacing_leftweight != 0:
        b = hi[..., 0] - hi[..., 1]
        a = hi[..., 1] + ((b * coding.interlacing_leftweight) >> coding.interlacing_shift)
        chans = np.stack([a, b], axis=1)  # (F, C, S)
    else:
        chans = np.moveaxis(hi, 2, 1)
    lanes = chans.reshape(F * C, S)
    lane_n = np.repeat(n, C)
    L = F * C
    if isinstance(orders, tuple):
        cands = np.asarray(sorted(orders), np.int64)
        tries = [_predict(lanes, lane_n, np.full(L, o), coding, rss) for o in cands]
        v_all, w_all = rice_fields(np.concatenate([e for _, e in tries]),
                                   np.tile(lane_n, cands.size), rss, coding.rice_modifier)
        T = w_all.shape[1]
        v_all = v_all.reshape(cands.size, L, T, 4)
        w_all = w_all.reshape(cands.size, L, T, 4)
        cost = w_all.reshape(cands.size, L, -1).sum(axis=2) + _coef_bits(cands)[:, None]
        pick = np.argmin(cost, axis=0)
        lane_order = cands[pick]
        lane = np.arange(L)
        coefs = np.stack([c for c, _ in tries])[pick, lane]
        vals, wids = v_all[pick, lane], w_all[pick, lane]
    else:
        o = np.asarray(orders, np.int64)
        o = o.reshape(-1, 1) if o.ndim < 2 else o
        lane_order = np.broadcast_to(o, (F, C)).reshape(L)
        coefs, err = _predict(lanes, lane_n, lane_order, coding, rss)
        vals, wids = rice_fields(err, lane_n, rss, coding.rice_modifier)
    L, T, _ = wids.shape
    rbits = wids.reshape(L, -1).sum(axis=1)  # (L,)

    # Header fields, per frame (few): tag, 4+12 zero bits, hassize, ub,
    # isnotcompressed, the size, shift and weight, each channel's
    # prediction header and coefficients.
    h_frame, h_off, h_val, h_wid = [], [], [], []
    head_bits = np.zeros(F, np.int64)
    for f in range(F):
        hassize = int(n[f] != coding.max_samples_per_frame)
        v = [0 if C == 1 else 1, 0, 0, hassize, ub, 0]
        w = [3, 4, 12, 1, 2, 1]
        if hassize:
            v.append(int(n[f]))
            w.append(32)
        if C == 1:
            v += [0, 0]
        else:
            v += [coding.interlacing_shift, coding.interlacing_leftweight]
        w += [8, 8]
        for c in range(C):
            order = int(lane_order[f * C + c])
            count = 31 if order == 31 else order
            v += [0, coding.quant, coding.rice_modifier, order]
            w += [4, 4, 3, 5]
            v += [int(x) & 0xFFFF for x in coefs[f * C + c, :count]]
            w += [16] * count
        offs = np.concatenate([[0], np.cumsum(w)[:-1]])
        h_frame.append(np.full(len(v), f))
        h_off.append(offs)
        h_val.append(np.asarray(v, np.int64))
        h_wid.append(np.asarray(w, np.int64))
        head_bits[f] = sum(w)
    parts_f = [np.concatenate(h_frame)]
    parts_o = [np.concatenate(h_off)]
    parts_v = [np.concatenate(h_val)]
    parts_w = [np.concatenate(h_wid)]
    extra_bits = n * C * 8 * ub
    if ub:
        # interleaved extra bits, A then B per sample
        s_idx = np.arange(S)
        live = s_idx[None, :] < n[:, None]  # (F, S)
        ff, ss = np.nonzero(live)
        for c in range(C):
            parts_f.append(ff)
            parts_o.append(head_bits[ff] + 8 * ub * (ss * C + c))
            parts_v.append(extra[ff, ss, c])
            parts_w.append(np.full(ff.size, 8 * ub, np.int64))
    # Rice sections: channel A, then B, after the header and extra bits
    lane_start = np.repeat(head_bits + extra_bits, C)
    if C == 2:
        lane_start[1::2] += rbits[0::2]
    flat_w = wids.reshape(L, -1)
    flat_v = vals.reshape(L, -1)
    within = np.cumsum(flat_w, axis=1) - flat_w
    parts_f.append(np.repeat(np.arange(L) // C, flat_w.shape[1]))
    parts_o.append((lane_start[:, None] + within).reshape(-1))
    parts_v.append(flat_v.reshape(-1))
    parts_w.append(flat_w.reshape(-1))
    frame_bits = head_bits + extra_bits + rbits.reshape(F, C).sum(axis=1)
    payloads = pack_fields(
        np.concatenate(parts_f), np.concatenate(parts_o), np.concatenate(parts_v),
        np.concatenate(parts_w), frame_bits,
    )
    return Coded(payloads, rbits.reshape(F, C), lane_order.reshape(F, C).copy())
