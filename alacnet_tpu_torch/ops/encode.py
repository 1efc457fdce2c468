"""Batch ALAC encoding stages in plain torch.

The counterpart of ``alacnet_tpu/ops/encode.py``: the two sequential
per-sample automatons of the encoder, frame-per-lane with stereo
channels folded into extra lanes, and the elementwise glue around them.

  * :func:`predictor_errors` — the forward adaptive FIR: runs the
    decoder's reconstruction (AlacFile.cs:256-336) in lockstep over the
    *known* signal and solves for each residual, mutating the
    coefficient table exactly as the decoder will (the base-aligned
    window/coefficient layout of ``ops/lpc.py``, with the window
    carrying inputs).  The plain version of the ``enc_pred`` kernel.
  * :func:`rice_symbols` — the Rice/adaptive-Golomb emitter
    (EntropyRiceDecode's state machine run forward, AlacFile.cs:214-252):
    up to four (value, width) bit fields per sample.  With
    :func:`merge_symbol_chunks` it is the plain version of the
    ``enc_rice`` kernel.
  * :func:`zero_run_lengths` — the zero-run lookahead, a reverse cummin.
  * :func:`merge_pair_chunks` — folds adjacent samples' 96-bit chunks
    into the native pair packer's planes; :func:`merge_quad_chunks`
    folds adjacent pairs once more.
  * :func:`encode_stages` / :func:`encode_stages_pcm` — the device stage
    of ``codec/encoder_device.py``, routed through the kernel wrappers
    of ``ops/cuda/enc_stages.py``.
  * :func:`pack_frames_device` / :func:`pack_frames_device_scatter` —
    whole coded frame bodies assembled on the device from the chunk
    planes (a gather and a scatter formulation of one prefix-sum
    problem), so only the coded bytes cross to the host.

Every tensor holds int32 (96-bit chunks as int32 bit patterns: torch has
few ``uint32`` ops); wraparound follows C# int32 as in ``ops/bitops.py``.
The loops over samples are Python loops of (B,) tensor ops: the plain
versions are for the CPU and for holding the kernels to account.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..codec.cookie import RICE_THRESHOLD
from .bitops import I32, I64, clz32, lsr, sign_i32, signext, wrap32
from .lpc import MAX_ORDER, LpcParams

I8 = torch.int8


class RiceEncParams(NamedTuple):
    """Per-lane Rice emitter parameters, (B,) int32 each."""

    rss: torch.Tensor
    kmod: torch.Tensor
    init_history: torch.Tensor
    mult: torch.Tensor
    kmask: torch.Tensor


def params_from_numpy(lp, rp, device) -> tuple[LpcParams, RiceEncParams]:
    """The port's (LpcParams, RiceEncParams) on ``device`` from the JAX
    package's (or any) pair of named tuples of (B,)/(B, 32) arrays."""

    def t(x):
        return torch.from_numpy(np.array(x, np.int32)).to(device)

    return (
        LpcParams(order=t(lp.order), quant=t(lp.quant), rc=t(lp.rc), rss=t(lp.rss)),
        RiceEncParams(*(t(x) for x in rp)),
    )


def predictor_errors(
    sig, n, params: LpcParams, num_samples: int, max_order: int = MAX_ORDER
):
    """Residuals whose decode reproduces ``sig`` bit-exactly.

    sig: (B, S) int32 channel values (decorrelated, extra-bits split
    off); n: (B,) valid counts; params as for ``ops/lpc.lpc_decode``.
    ``max_order`` bounds the FIR width and the adaptive walk (pass at
    least every lane's order below 31).  Returns errs (B, S) int32, zero
    at i >= n.
    """
    order = params.order.to(I32)
    quant = params.quant.to(I32)
    rss = params.rss.to(I32)
    B = sig.shape[0]
    dev = sig.device
    S = num_samples
    tmax = max_order
    errs = torch.zeros((B, S), dtype=I32, device=dev)
    if B == 0 or S == 0:
        return errs

    is_pass = order == 0
    is_int31 = order == MAX_ORDER
    append_hot = (
        torch.arange(tmax + 1, dtype=I32, device=dev)[None, :] == order[:, None]
    )
    qshift = (quant - 1) & 31

    # i = 0: err[0] = sig[0] verbatim (AlacFile.cs first-sample copy).
    x0 = sig[:, 0].to(I32)
    errs[:, 0] = torch.where(n > 0, x0, 0)
    prev = x0
    D = torch.where(append_hot, x0[:, None], 0).to(I32)
    rc = params.rc.to(I32)[:, : tmax + 1].clone()
    # Outputs past every lane's n are zero, and nothing after them is
    # returned: the loop stops at the largest n.
    steps = min(S, max(1, int(n.max())))
    for i in range(1, steps):
        x = sig[:, i].to(I32)
        # integration/warm-up residual (AlacFile.cs:276-292 inverted)
        err_int = signext(x - prev, rss)
        base = D[:, 0]
        fir = ((D[:, 1:] - base[:, None]) * rc[:, 1:]).sum(dim=1, dtype=I32)
        outval = ((1 << qshift) + fir) >> quant
        err_fir = signext(x - outval - base, rss)

        use_int = is_int31 | (i <= order)
        err = torch.where(is_pass, x, torch.where(use_int, err_int, err_fir))

        # adaptive coefficient walk — the decoder's (ops/lpc.py), with
        # window values = inputs
        do_adapt = ~(is_pass | is_int31 | use_int)
        pos_b = do_adapt & (err > 0)
        neg_b = do_adapt & (err < 0)
        ev = err
        vals = base[:, None] - D[:, 1:]
        sgns = sign_i32(vals)
        for t in range(tmax):
            act_p = pos_b & (t < order) & (ev > 0)
            act_n = neg_b & (t < order) & (ev < 0)
            act = act_p | act_n
            # A lane that stops acting never acts again (ev keeps its
            # sign, t < order only turns false): the walk ends once no
            # lane acts.
            if not bool(act.any()):
                break
            val, sgn = vals[:, t], sgns[:, t]
            sign_eff = torch.where(act_p, sgn, torch.where(act_n, -sgn, 0))
            rc[:, t + 1] -= sign_eff
            ev = torch.where(act, ev - ((val * sign_eff) >> quant) * (t + 1), ev)

        # advance the window with the INPUT sample (== decoder's output)
        shifted = torch.cat([D[:, 1:], D[:, :1]], dim=1)
        D = torch.where(append_hot, x[:, None], shifted)

        live = i < n
        errs[:, i] = torch.where(live, err, 0)
        prev = torch.where(live, x, prev)
    return errs


def zero_run_lengths_sb(errs_sb, n):
    """:func:`zero_run_lengths` on the sample-major (S, B) layout the
    kernels use: the reverse cummin runs along dim 0."""
    S = errs_sb.shape[0]
    idx = torch.arange(S, dtype=I32, device=errs_sb.device)[:, None]
    # positions that BREAK a zero run: nonzero residual or past n
    brk = (errs_sb != 0) | (idx >= n.to(I32)[None, :])
    nz_idx = torch.where(brk, idx, S).to(I32)
    # suffix minimum: index of the next break at or after i
    next_brk = torch.flip(torch.cummin(torch.flip(nz_idx, [0]), dim=0).values, [0])
    run_from = next_brk - idx  # zeros starting at i
    run_after = torch.zeros_like(run_from)
    run_after[:-1] = run_from[1:]
    return torch.clamp_max(run_after, 0xFFFF)


def zero_run_lengths(errs, n, num_samples: int):
    """(B, S) runs of zero residuals starting at i+1 (capped at n).

    Vectorized lookahead for the encoder's zero-run symbol
    (AlacFile.cs:231-249): run[i] = #{j > i : errs[i+1..j] all zero},
    stopping at the lane's n (the reference's ``i + 1 + run < n`` walk).
    """
    assert errs.shape[1] == num_samples
    return zero_run_lengths_sb(errs.t(), n).t()


def _shl(x, c):
    """x << c with jax.lax semantics: counts outside [0, 31] give 0."""
    return torch.where((c < 0) | (c > 31), 0, x << (c & 31))


def _emit_sym(raw, rss, k, mask):
    """(v0,w0,v1,w1) bit fields for one entropy symbol (AlacFile.cs:193-212
    run forward).  Division-free: quotients above RICE_THRESHOLD escape."""
    k_safe = torch.clamp(k, 1, 31)
    m = wrap32(((1 << k_safe.to(I64)) - 1) & (mask.to(I64) & 0xFFFFFFFF))
    rem = raw
    q = torch.zeros_like(raw)
    for _ in range(RICE_THRESHOLD + 1):
        c = (m > 0) & (rem >= m)
        rem = rem - torch.where(c, m, 0)
        q = q + c.to(I32)
    esc_q = (m <= 0) | (q > RICE_THRESHOLD)
    is_k1 = k == 1
    esc = torch.where(is_k1, raw > RICE_THRESHOLD, esc_q)
    uq = torch.where(is_k1, torch.clamp_max(raw, RICE_THRESHOLD), q)
    # unary: uq one-bits then a zero = (2^(uq+1) - 2), width uq+1
    v0 = torch.where(esc, 0x1FF, _shl(torch.ones_like(uq), uq + 1) - 2)
    w0 = torch.where(esc, 9, uq + 1)
    r = rem
    v1 = torch.where(esc, raw, torch.where(is_k1, 0, torch.where(r == 0, 0, r + 1)))
    w1 = torch.where(
        esc, rss, torch.where(is_k1, 0, torch.where(r == 0, k_safe - 1, k_safe))
    )
    return v0.to(I32), w0.to(I32), v1.to(I32), w1.to(I32)


def rice_symbols(errs, zruns, n, params: RiceEncParams, num_samples: int):
    """Run the Rice emitter automaton -> fixed-arity bit-field planes.

    Returns (vals16 (B, S, 2) int16 — the unary/marker fields [v0, v2],
    vals32 (B, S, 2) int32 — the remainder/escape fields [v1, v3],
    widths (B, S, 4) int8 in field order v0,v1,v2,v3, bad (B,) bool).
    Fields with width 0 are no-ops for the packer; ``bad`` flags the
    (construction-impossible) encoder desync raw < 0.

    The symbols never feed back into the automaton's state (history,
    sign modifier, skip), so the loop over samples runs the state alone
    and records each sample's inputs to the two symbol emissions, which
    then run once over the whole (B, S) plane.
    """
    rss = params.rss.to(I32)
    kmod = params.kmod.to(I32)
    mult = params.mult.to(I32)
    kmask = params.kmask.to(I32)
    B = errs.shape[0]
    S = num_samples
    dev = errs.device
    n = n.to(I32)
    errs = errs.to(I32)
    zruns = zruns.to(I32)
    dv = torch.where(errs > 0, 2 * errs, torch.where(errs < 0, -2 * errs - 1, 0))

    hist = torch.empty((B, S), dtype=I32, device=dev)  # h before sample i
    h2s = torch.empty((B, S), dtype=I32, device=dev)
    raws = torch.empty((B, S), dtype=I32, device=dev)
    actives = torch.empty((B, S), dtype=torch.bool, device=dev)
    zconds = torch.empty((B, S), dtype=torch.bool, device=dev)
    h = params.init_history.to(I32)
    sgnmod = torch.zeros((B,), dtype=I32, device=dev)
    skip = torch.zeros_like(sgnmod)
    for i in range(S):
        d = dv[:, i]
        zr = zruns[:, i]
        in_skip = skip > 0
        active = (i < n) & ~in_skip
        h2 = torch.where(d > 0xFFFF, 0xFFFF, h + d * mult - ((h * mult) >> 9))
        zcond = (h2 < 128) & (i + 1 < n)
        hist[:, i] = h
        h2s[:, i] = h2
        raws[:, i] = d - sgnmod
        actives[:, i] = active
        zconds[:, i] = zcond
        h = torch.where(active, torch.where(zcond, 0, h2), h).to(I32)
        sgnmod = torch.where(active, zcond.to(I32), sgnmod)
        skip = torch.where(
            active, torch.where(zcond, zr, 0),
            torch.where(in_skip & (i < n), skip - 1, skip),
        ).to(I32)

    bad = (actives & (raws < 0)).any(dim=1)
    kmod2 = kmod[:, None]
    ik = 31 - kmod2 - clz32((hist >> 9) + 3)
    k = torch.where(ik < 0, ik + kmod2, kmod2)
    v0, w0, v1, w1 = _emit_sym(raws, rss[:, None], k, torch.full_like(k, -1))
    kz = torch.clamp_max(clz32(h2s) + ((h2s + 16) >> 6) - 24, 31)
    v2, w2, v3, w3 = _emit_sym(
        zruns, torch.full_like(kz, 16), kz, kmask[:, None].expand(B, S)
    )
    emit_z = actives & zconds
    vals16 = torch.stack([v0, v2], dim=-1).to(torch.int16)
    vals32 = torch.stack([v1, v3], dim=-1)
    widths = torch.stack(
        [
            torch.where(actives, w0, 0),
            torch.where(actives, w1, 0),
            torch.where(emit_z, w2, 0),
            torch.where(emit_z, w3, 0),
        ],
        dim=-1,
    ).to(I8)
    return vals16, vals32, widths, bad


def _shl_s(x, c):
    """u32 << c with c in [0, 32] (c >= 32 -> 0), on int32 patterns."""
    return torch.where(c >= 32, 0, x << (c & 31))


def _shr_s(x, c):
    """Logical u32 >> c with c in [0, 32], on int32 patterns."""
    return torch.where(c >= 32, 0, lsr(x, c & 31))


def merge_symbol_chunks(vals16, vals32, widths):
    """Fold each sample's four bit fields into one right-aligned 96-bit
    chunk, so the host packer writes ONE multi-word field per
    channel-sample.

    Returns (c0, c1, c2 (B, S) int32 bit patterns — c0 holds the high
    bits, value right-aligned in the low ``ws`` bits of c0:c1:c2 — and
    ws (B, S) int8 total widths, <= 9+32+9+31 = 81).  Width-0 fields are
    no-ops, matching the packer's convention.
    """
    h = torch.zeros(vals16.shape[:2], dtype=I32, device=vals16.device)
    m = torch.zeros_like(h)
    l = torch.zeros_like(h)  # noqa: E741
    fields = (
        (vals16[:, :, 0], widths[:, :, 0]),
        (vals32[:, :, 0], widths[:, :, 1]),
        (vals16[:, :, 1], widths[:, :, 2]),
        (vals32[:, :, 1], widths[:, :, 3]),
    )
    for val, w in fields:
        w = w.to(I32)
        mask = _shl_s(torch.ones_like(w), w) - 1  # w=32 -> 0-1 = all ones
        v = val.to(I32) & mask
        inv = 32 - w
        h = _shl_s(h, w) | _shr_s(m, inv)
        m = _shl_s(m, w) | _shr_s(l, inv)
        l = _shl_s(l, w) | v  # noqa: E741
    ws = widths.to(I32).sum(dim=2)
    return h, m, l, ws.to(I8)


def merge_pair_chunks(c0, c1, c2, ws):
    """Fold ADJACENT SAMPLES' 96-bit chunks into one 96-bit pair field,
    so the host packer writes one multi-word field per TWO
    channel-samples (and the planes' D2H halves).

    Pair j covers samples (2j, 2j+1); sample widths past the lane's live
    count are 0, so an odd count just merges a zero-width tail.  A pair
    FITS when its combined width is <= 96 bits (each sample alone is
    <= 81).  A non-fitting pair — two adjacent near-maximal escape +
    zero-run samples — sets ``fat`` for its lane, and the caller
    re-dispatches the classic per-sample planes for that batch
    (codec/encoder_device._pack_host_pairs).

    Returns (ph, pm, pl (B, ceil(S/2)) int32 bit patterns — pair value
    right-aligned in the low ``pws`` bits of ph:pm:pl — pws
    (B, ceil(S/2)) int8 combined widths (-1 for non-fitting pairs), fat
    (B,) bool).
    """
    if ws.shape[1] % 2:
        pad = (0, 1)
        c0, c1, c2, ws = (torch.nn.functional.pad(x, pad) for x in (c0, c1, c2, ws))
    wa = ws[:, 0::2].to(I32)
    wb = ws[:, 1::2].to(I32)
    wp = wa + wb
    fits = wp <= 96
    # A's 96-bit chunk shifted left by wb (0..96): sub-word shift by
    # r = wb & 31 on the 3-word ladder, then a word roll by wb >> 5.
    r = wb & 31
    inv = 32 - r  # in [1, 32]; _shr_s handles 32
    ah, am, al = c0[:, 0::2], c1[:, 0::2], c2[:, 0::2]
    h = _shl_s(ah, r) | _shr_s(am, inv)
    m = _shl_s(am, r) | _shr_s(al, inv)
    l = _shl_s(al, r)  # noqa: E741
    q = wb >> 5  # 0..2 for fitting pairs (wb <= 81)
    h2 = torch.where(q == 0, h, torch.where(q == 1, m, l))
    m2 = torch.where(q == 0, m, torch.where(q == 1, l, 0))
    l2 = torch.where(q == 0, l, 0)
    # B sits in the low wb bits; disjoint from A << wb when the pair
    # fits (wa <= 96 - wb), so plain ORs compose the pair.
    ph = h2 | c0[:, 1::2]
    pm = m2 | c1[:, 1::2]
    pl = l2 | c2[:, 1::2]
    pws = torch.where(fits, wp, -1).to(I8)
    fat = (~fits).any(dim=1)
    return ph, pm, pl, pws, fat


def merge_quad_chunks(ph, pm, pl, pws):
    """Fold ADJACENT PAIRS' <=96-bit fields into one <=96-bit QUAD field:
    :func:`merge_pair_chunks` applied to its own output, so the host
    packer writes one field per FOUR samples.  The native pair packer
    takes the quad planes unchanged when handed ceil(n/2) as each
    frame's count (codec/encoder_device._pack_host_pairs).

    A quad FITS when its combined width is <= 96 bits (four samples of
    <= 24 bits on average: 16-bit content without adjacent escapes).  A
    non-fitting PAIR input (-1 width) poisons its lane too: widths are
    clamped to 0 for the shifts, and the lane is marked fat.

    Returns (qh, qm, ql (B, ceil(S/4)) int32 bit patterns, qws
    (B, ceil(S/4)) int8, qfat (B,) bool).
    """
    bad_pair = (pws < 0).any(dim=1)
    qh, qm, ql, qws, qfat = merge_pair_chunks(ph, pm, pl, torch.clamp_min(pws, 0))
    return qh, qm, ql, qws, qfat | bad_pair


def encode_stages(sig, n, lp: LpcParams, rp: RiceEncParams, num_samples: int,
                  max_order: int = MAX_ORDER, kernel: str = "auto",
                  pairs: bool = False, quads: bool = False):
    """One-dispatch device encode: residuals -> zero-run lookahead ->
    rice symbols -> merged chunk planes, through the kernel wrappers of
    ``ops/cuda/enc_stages.py`` (``kernel`` routes them: "auto" launches
    the CUDA kernels for CUDA tensors and runs the plain versions above
    for CPU tensors).

    Returns (c0, c1, c2 (B, S) int32 bit patterns, ws (B, S) int8,
    bits (B,) int32 per-lane entropy-section bit totals, bad (B,) bool).
    ``pairs``: additionally fold adjacent samples via
    :func:`merge_pair_chunks` and return (ph, pm, pl, pws, bits, bad,
    fat) — the native pair packer's input.  ``quads`` (requires
    ``pairs``): also fold adjacent pairs via :func:`merge_quad_chunks`
    and append (qh, qm, ql, qws (B, ceil(S/4)), qfat (B,)) to the pair
    tuple.  Both folds run in one call of the ``pair_merge`` kernel's
    wrapper (``ops/cuda/pair_merge.py``), whose planes are lane-major on
    the kernel route.  Every plane stays on the device: the caller
    copies back the flags first, then only the plane set it packs.
    """
    from .cuda.enc_stages import encode_stages_fused
    from .cuda.pair_merge import merge_pair_chunks_fused

    if quads and not pairs:
        raise ValueError("quads requires pairs")
    c0, c1, c2, ws, bits, bad = encode_stages_fused(
        sig, n, lp, rp, num_samples, max_order=max_order, kernel=kernel
    )
    if pairs:
        merged = merge_pair_chunks_fused(c0, c1, c2, ws, quads=quads, kernel=kernel)
        return (*merged[:4], bits, bad, *merged[4:])
    return c0, c1, c2, ws, bits, bad


def encode_stages_pcm(
    pcm, stereo, n, lp: LpcParams, rp: RiceEncParams, num_samples: int,
    max_order: int = MAX_ORDER, lw: int = 0, sh: int = 0, ub8: int = 0,
    wide: bool = False, kernel: str = "auto", pairs: bool = False,
    quads: bool = False,
):
    """:func:`encode_stages` fed raw interleaved PCM.

    ``pcm``: (F, S, 2) int32 (channel 1 zeroed for mono lanes);
    ``stereo``: (F,) bool.  The extra-bits strip (``>> ub8``), stereo
    decorrelation (AlacFile.cs mid/side inverse run forward:
    cb = L - R, ca = R + ((cb*lw) >> sh)) and the channel fold into 2F
    lanes run on the device, in one call of the ``enc_prologue`` kernel's
    wrapper (``ops/cuda/enc_prologue.py``), whose sample-major (S, 2F)
    output goes on as its (2F, S) view, so that the predictor kernel
    reads it without a transposing copy.  ``wide`` marks post-strip
    sample widths over 16 bits (24-bit no-extra-bits content), where
    |cb| * leftweight can pass 2^31: the product is then taken in int64
    and truncated to int32, as the host encoder does (the JAX package
    emulates the same bits with a split int32 product).  Narrow content
    multiplies directly: no product overflows.
    """
    from .cuda.enc_prologue import encode_prologue_fused

    sig = encode_prologue_fused(pcm, stereo, lw, sh, ub8, wide, kernel=kernel).t()
    return encode_stages(
        sig, n, lp, rp, num_samples, max_order=max_order, kernel=kernel,
        pairs=pairs, quads=quads,
    )


# ---------------------------------------------------------------------------
# Device-side frame packing: the coded BYTES leave the device.
# ---------------------------------------------------------------------------


def pack_frames_device(c0, c1, c2, ws, n, stereo, hbits, stride_words: int,
                       K: int = 34):
    """Assemble whole coded frame BODIES on the device from the merged
    96-bit sample chunks, so the host packer leaves the pipeline and the
    copy back shrinks from ~13 B/sample of chunk planes to the coded
    bytes themselves.

    Bit packing is a prefix-sum problem: each output 32-bit word's
    content depends only on which symbols overlap its bit range.  Three
    vector phases, no scan over samples:

      1. fold the chunk planes frame-major (channel A's symbols, then
         B's: the bitstream's order, AlacFile.cs:643,653) and COMPACT
         away zero-width slots (zero-run-compressed samples emit
         nothing; without compaction a silence run would starve the
         bounded gather window below);
      2. ``ends = hbits + cumsum(widths)``: every symbol's absolute bit
         range, the body offset by the frame's header bit count so the
         host can OR the ragged header fields into the zeroed prefix;
      3. for every output word j: ``searchsorted(ends, 32j)`` finds the
         first overlapping symbol; OR together the next ``K``
         candidates' in-window bits (a 32-bit window meets at most
         32/min_width + 2 <= 34 compacted symbols, each >= 1 bit).

    Inputs: ``c0, c1, c2`` (B, S) int32 bit patterns of right-aligned,
    masked chunks; ``ws`` (B, S) int8 widths (lane f = channel A of
    frame f, lane F + f = channel B); ``n`` (F,) valid samples;
    ``stereo`` (F,) bool; ``hbits`` (F,) int32 header bit counts.
    Returns (rows (F, stride_words*4) uint8, the big-endian bit stream
    with the header region zeroed, and end_bits (F,) int32).  Plain
    torch ops: the JAX package's version is XLA outside any Pallas
    kernel.

    The extra-bits plane (ub != 0) is NOT packed here; callers keep
    those frames on the host packer.
    """
    a0, a1, a2, starts, ends, end_bits, NS = _pack_fold_compact(
        c0, c1, c2, ws, n, stereo, hbits
    )
    F = ws.shape[0] // 2
    lo_row = torch.arange(stride_words, dtype=I32, device=ws.device) * 32
    first = torch.searchsorted(
        ends, lo_row.expand(F, stride_words).contiguous(), right=True, out_int32=True
    )
    lo = lo_row[None, :]
    hi = lo + 32
    acc = torch.zeros((F, stride_words), dtype=I32, device=ws.device)
    for t in range(K):
        k = first + t
        kc = torch.clamp_max(k, NS - 1).long()
        st = starts.gather(1, kc)
        en = ends.gather(1, kc)
        win = _win32(a0.gather(1, kc), a1.gather(1, kc), a2.gather(1, kc), en - hi)
        live = (k < NS) & (st < hi) & (en > lo) & (en > st)
        acc |= torch.where(live, win, 0)
    return _rows_be(acc), end_bits


def _pack_fold_compact(c0, c1, c2, ws, n, stereo, hbits):
    """Phases 1-2 shared by the two packers: frame-major channel fold,
    zero-width compaction, absolute bit ranges.  Returns (a0, a1, a2,
    starts, ends (F, 2S) int32, end_bits (F,) int32, 2S)."""
    F, S = ws.shape[0] // 2, ws.shape[1]
    NS = 2 * S
    dev = ws.device
    samp = torch.arange(S, dtype=I32, device=dev)[None, :]
    mA = samp < n.to(I32)[:, None]
    mB = mA & stereo.to(torch.bool)[:, None]

    def fold(plane):
        plane = plane.to(I32)
        return torch.cat(
            [torch.where(mA, plane[:F], 0), torch.where(mB, plane[F:], 0)], dim=1
        )

    ws_f = fold(ws)
    mask = ws_f > 0
    # Real symbols move to the front of their row; dropped slots land in
    # one spare column past the row's end, which is cut off.
    dest = torch.where(mask, torch.cumsum(mask, dim=1, dtype=I32) - 1, NS).long()

    def compact(plane):
        out = torch.zeros((F, NS + 1), dtype=I32, device=dev)
        return out.scatter_(1, dest, plane)[:, :NS]

    cw = compact(ws_f)
    a0, a1, a2 = (compact(fold(c)) for c in (c0, c1, c2))
    ends = (hbits.to(I32)[:, None] + torch.cumsum(cw, dim=1, dtype=I32)).contiguous()
    starts = ends - cw
    return a0, a1, a2, starts, ends, ends[:, -1], NS


def _win32(v0, v1, v2, s):
    """The 32-bit window of the 96-bit value v0:v1:v2 whose LSB sits
    ``s`` bits above the value's LSB (s >= 0: the field extends past the
    window; s < 0: the field ends -s bits inside it)."""
    sr = torch.clamp_min(s, 0)
    right = torch.where(
        sr < 32,
        _shr_s(v2, sr) | _shl_s(v1, 32 - sr),
        torch.where(
            sr < 64,
            _shr_s(v1, sr - 32) | _shl_s(v0, 64 - sr),
            _shr_s(v0, torch.clamp_max(sr - 64, 32)),
        ),
    )
    left = _shl_s(v2, torch.clamp_min(-s, 0))
    return torch.where(s >= 0, right, left)


def _rows_be(acc):
    """(F, W) int32 words -> (F, W*4) uint8 big-endian stream bytes."""
    F, W = acc.shape
    be = lsr(acc, 24) | (lsr(acc, 8) & 0xFF00) | ((acc << 8) & 0xFF0000) | (acc << 24)
    return be.contiguous().view(torch.uint8).reshape(F, W * 4)


def pack_frames_device_scatter(c0, c1, c2, ws, n, stereo, hbits,
                               stride_words: int):
    """Scatter-add formulation of :func:`pack_frames_device`, same
    inputs and outputs: instead of each output word GATHERING its <= K
    overlapping symbols, each symbol SCATTERS its <= 4 word contributions
    (a <= 81-bit chunk spans at most ceil((81+31)/32) = 4 words).
    Contributions to a shared word occupy disjoint bit ranges, so an
    int32 scatter-add is exactly bitwise OR (no carry, so no overflow);
    dead contributions, and any word past ``stride_words``, add 0 into
    one spare column that is cut off."""
    a0, a1, a2, starts, ends, end_bits, NS = _pack_fold_compact(
        c0, c1, c2, ws, n, stereo, hbits
    )
    F = ws.shape[0] // 2
    j0 = starts >> 5
    acc = torch.zeros((F, stride_words + 1), dtype=I32, device=ws.device)
    for t in range(4):
        j = j0 + t
        live = (ends > starts) & (j * 32 < ends) & (j < stride_words)
        val = torch.where(live, _win32(a0, a1, a2, ends - (j * 32 + 32)), 0)
        acc.scatter_add_(1, torch.where(live, j, stride_words).long(), val)
    return _rows_be(acc[:, :stride_words]), end_bits
