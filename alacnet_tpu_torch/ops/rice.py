"""Frame-parallel Rice / adaptive-Golomb entropy decode in plain torch.

The counterpart of ``alacnet_tpu/ops/rice.py`` (EntropyRiceDecode,
AlacFile.cs:214-252 + EntropyDecodeValue :193-212): a Python loop over
the output sample index with (B,) lane state (bit cursor, history, sign
modifier, zero-run remaining).  It is the plain version of the
``rice_lpc`` CUDA kernel's entropy half; see the JAX module for the
bit-exactness notes, which hold here expression for expression.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..codec.cookie import RICE_THRESHOLD
from .bitops import I32, clz32, trunc_div2_plus1, trunc_div_const
from .bitreader import WINDOW_WORDS


class RiceParams(NamedTuple):
    """Per-lane entropy parameters (all (B,) int32)."""

    rss: torch.Tensor  # readsamplesize
    kmod: torch.Tensor  # rice_kmodifier
    init_history: torch.Tensor  # rice_initialhistory
    mult: torch.Tensor  # ricemodifier * (historymult / 4)
    kmask: torch.Tensor  # (1 << kmod) - 1


_MASK32 = 0xFFFFFFFF


def _window_pairs(words, pos):
    """The 4 words covering ``pos`` per lane, as 3 overlapping 64-bit
    pairs (B, 3) int64: pairs[:, j] = word j : word j+1 (unsigned).

    The window starts at clip(pos >> 5, 0, W-4), as the JAX reader's
    gather does.
    """
    W = words.shape[1]
    w = torch.clamp(pos >> 5, 0, W - WINDOW_WORDS).to(torch.int64)
    idx = w[:, None] + torch.arange(WINDOW_WORDS, device=words.device)
    win = torch.gather(words, 1, idx).to(torch.int64) & _MASK32
    return (win[:, :3] << 32) | win[:, 1:]


def _window32(pairs, sh, off):
    """The 32 bits at window bit offset ``sh + off``, left-aligned, as
    int64 in [0, 2**32).  Like the JAX ``window_bits``, any word index
    other than 0 or 1 reads words 2:3."""
    p = sh + off
    wi = p >> 5
    wi = torch.where((wi == 0) | (wi == 1), wi, 2).to(torch.int64)
    pair = torch.gather(pairs, 1, wi[:, None])[:, 0]
    return (pair >> (32 - (p & 31))) & _MASK32


def _decode_event(pairs, sh, off, rss, k, mult_mask):
    """One entropy_decode_value: returns (value, consumed bits), int32.

    One window serves both speculative reads after the unary run
    (escape ``rss`` bits vs ``k`` bits), as in the JAX kernel.
    """
    u9 = _window32(pairs, sh, off) >> 23
    inv = (~u9) & 0x1FF
    x = torch.clamp(clz32((inv << 23).to(I32)), max=RICE_THRESHOLD + 1)
    unary_consumed = torch.where(x > RICE_THRESHOLD, 9, x + 1)

    esc = x > RICE_THRESHOLD
    fwin = _window32(pairs, sh, off + unary_consumed)
    esc_val = (fwin >> ((32 - rss) & 31)).to(I32)
    k_safe = torch.clamp(k, 1, 31)
    extra = (fwin >> ((32 - k_safe) & 31)).to(I32)
    # (1<<k)-1 with int32 wraparound (k=31 -> 0x7FFFFFFF), then the
    # caller's multiplier mask (AlacFile.cs:206).
    m = ((1 << k_safe) - 1) & mult_mask
    vk = x * m + torch.where(extra > 1, extra - 1, 0)
    k_consumed = torch.where(extra > 1, k_safe, k_safe - 1)

    is_k1 = k == 1
    value = torch.where(esc, esc_val, torch.where(is_k1, x, vk))
    consumed = unary_consumed + torch.where(
        esc, rss, torch.where(is_k1, 0, k_consumed)
    )
    return value.to(I32), consumed.to(I32)


class RiceState(NamedTuple):
    """Per-lane entropy state between samples (all (B,) int32)."""

    pos: torch.Tensor  # bit cursor
    hist: torch.Tensor  # adaptive history
    signmod: torch.Tensor  # sign modifier after a zero run
    zrun: torch.Tensor  # zero samples still to emit


def rice_step(words, i: int, n, params: RiceParams, st: RiceState):
    """Sample ``i`` of every lane: (its residual (B,) int32, the state
    after it).  A lane past its ``n`` keeps its state and emits 0."""
    rss, kmod, mult, kmask = params.rss, params.kmod, params.mult, params.kmask
    pos, hist, signmod, zrun = st
    active = i < n
    in_zero = zrun > 0

    pairs = _window_pairs(words, pos)
    sh = pos & 31
    k = torch.minimum(31 - clz32((hist >> 9) + 3), kmod)
    raw, consumed = _decode_event(pairs, sh, 0, rss, k, -1)
    dv = raw + signmod
    almost = trunc_div2_plus1(dv)
    out_val = torch.where((dv & 1) != 0, -almost, almost)
    hist2 = torch.where(
        dv > 0xFFFF, 0xFFFF, hist + dv * mult - ((hist * mult) >> 9)
    )
    do = active & ~in_zero
    zcond = (hist2 < 128) & (i + 1 < n) & do
    if bool(zcond.any()):
        # ---- zero-run block (AlacFile.cs:231-249) ----
        kz = clz32(hist2) + trunc_div_const(hist2 + 16, 64) - 24
        bsize, bconsumed = _decode_event(pairs, sh, consumed, 16, kz, kmask)
        consumed = consumed + torch.where(zcond, bconsumed, 0)
        # A where over two Python scalars would give int64 and
        # promote signmod, then dv and hist, past 32 bits.
        new_signmod = (zcond & (bsize <= 0xFFFF)).to(I32)
        new_hist = torch.where(zcond, 0, hist2)
        new_zrun = torch.where(zcond, bsize, 0)
    else:
        new_signmod, new_hist, new_zrun = 0, hist2, 0

    out = torch.where(do, out_val, 0)
    return out, RiceState(
        pos=torch.where(do, pos + consumed, pos),
        hist=torch.where(do, new_hist, hist),
        signmod=torch.where(do, new_signmod, signmod),
        zrun=torch.where(do, new_zrun, torch.where(active & in_zero, zrun - 1, zrun)),
    )


def rice_decode(words, start_bitpos, n, params: RiceParams, num_samples: int):
    """Decode ``num_samples`` residuals per lane.

    words: (B, W) int32 packed payloads; start_bitpos, n: (B,) int32.
    Returns (errors (B, num_samples) int32, end_bitpos (B,) int32).
    The loop stops at the largest ``n`` (clipped to ``num_samples``),
    and a step decodes the zero-run block only when some lane starts
    one: both skip only work whose result every lane discards.
    """
    B = words.shape[0]
    dev = words.device
    # Every piece of lane state stays int32: a product such as hist *
    # mult must wrap at 32 bits, as the JAX scan's does.
    params = RiceParams(*(p.to(I32) for p in params))
    zeros = torch.zeros(B, dtype=I32, device=dev)
    st = RiceState(start_bitpos.to(I32), params.init_history, zeros, zeros)
    outs = torch.zeros((B, num_samples), dtype=I32, device=dev)
    steps = min(num_samples, max(0, int(n.max())) if B else 0)
    for i in range(steps):
        outs[:, i], st = rice_step(words, i, n, params, st)
    return outs, st.pos
