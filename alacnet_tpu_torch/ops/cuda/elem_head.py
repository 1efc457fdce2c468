"""The header of a multichannel frame's next element, parsed on the device.

A frame of 3-8 channels is a chain of elements (SCE, CPE, ..., END),
each bit-packed right after the one before, each with its own header;
element k+1 starts where element k's last Rice section ends, known only
after its entropy decode.  The host parses element 0 as it parses any
frame (``codec/framemeta_vec.py``); each later element's header is
parsed here, from the bit where the previous element ended, into the
columns the decode's stages read (``ops/frame_decode._element_chain``).
No round trip to the host between elements.  Kernel 12 of the decode
path (``csrc/elem_head.cu``): a thread a lane.  The plain version is
:func:`elem_head_plain`, the same fields read with torch ops over the
lanes.

Output rows (``ROWS`` of them, (ROWS, B) int32): the 83 of the packed
layout (``FrameMetaArrays.pack_host``, transposed), then ``ROW_N_COMP``
and ``ROW_N_B`` (samples of channels A and B for the narrow ``rice_lpc``
launch, at the order bucket ``max_order``), ``ROW_BULK_N``,
``ROW_BULK_N1``, ``ROW_BULK_N2`` (the extra-bits or raw fields, one
``bulk_bits`` call for both), ``ROW_WIDE_A`` and ``ROW_WIDE_B`` (the
samples of a channel whose order is above ``max_order`` and below 31,
for the wide launch at the order-31 bucket), ``ROW_COFF`` (the element's
first output channel, -1 where the lane runs no stage) and
``ROW_STATUS`` (0, or 1 for a wrong tag, a sample count unlike element
0's or a missing END, 2 for a prediction type other than 0).  Flags:
(4, B) bool, is_stereo, is_compressed, and whether channel A's and
channel B's samples come from the wide launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ...codec.cookie import CHANNEL_ELEMENTS, ID_CPE, ID_DSE, ID_END, ID_FIL, ID_LFE, ID_SCE
from ..bitops import I32, I64
from ..lpc import MAX_ORDER
from . import _lib

#: Rows of the host's packed metadata (``FrameMetaArrays.N_PACKED``), then
#: the chain columns it appends for frames of 3 or more channels
#: (``FrameMetaArrays.pack_host``).  The C entry is given N_PACKED,
#: N_CHAINED and ROWS and refuses a layout other than its own.
N_PACKED = 83
COL_ELEMENTS, COL_HIST_MULT4, COL_FRAME, COL_OUT_CHANNELS = 83, 84, 85, 86
N_CHAINED = 87
ROW_N_COMP, ROW_N_B, ROW_BULK_N, ROW_BULK_N1, ROW_BULK_N2 = 83, 84, 85, 86, 87
ROW_WIDE_A, ROW_WIDE_B, ROW_COFF, ROW_STATUS = 88, 89, 90, 91
ROWS = 92
#: DSE / FIL elements skipped before one element (``kMaxSkips``).
MAX_SKIPS = 16
#: Elements of a frame of 8 channels, the most (``kMaxElements``).
MAX_ELEMENTS = max(len(k) for k in CHANNEL_ELEMENTS.values())

#: The elements column (``COL_ELEMENTS``) of a frame of each channel
#: count 0-8: the channels of each element of its map, 2 bits an
#: element, element 0's lowest; 0 at two channels and below (one
#: element, no chain).
ELEMENT_WORDS = np.array(
    [sum(kind << (2 * e) for e, kind in enumerate(CHANNEL_ELEMENTS[c])) if c > 2 else 0
     for c in range(9)], np.int32)


def element_kind(elements, e: int):
    """Channels of element ``e`` (1 or 2; 0 past the last) of each lane
    whose elements column is ``elements`` (an array or tensor)."""
    return (elements >> (2 * e)) & 3


def element_count(elements):
    """Elements of each lane's frame: its leading nonzero kinds."""
    count, more = 0, 1
    for e in range(MAX_ELEMENTS):
        more = more * (element_kind(elements, e) != 0)
        count = count + more
    return count


def _fields(words, W: int):
    """``bits(p, n)``: the n-bit field (1 <= n <= 32) at bit p of each
    lane's row, MSB first, zero outside the row (``Row::bits``)."""
    w64 = words.to(I64) & 0xFFFFFFFF
    lane = torch.arange(words.shape[0], device=words.device)

    def word(j):
        inside = (j >= 0) & (j < W)
        return torch.where(inside, w64[lane, torch.clamp(j, 0, max(W - 1, 0))], 0)

    def bits(p, n):
        j = p >> 5
        s = p & 31
        win = (word(j) << 32) | word(j + 1)
        n = torch.as_tensor(n, dtype=I64, device=words.device)
        return (win >> (64 - s - n)) & ((1 << n) - 1)

    return bits


def _skip_aux(bits, p):
    """DSE and FIL elements skipped from bit p (``skip_aux``); -1 after
    ``MAX_SKIPS`` of them."""
    done = torch.zeros_like(p, dtype=torch.bool)
    for _ in range(MAX_SKIPS):
        tag = bits(p, 3)
        dse = ~done & (tag == ID_DSE)
        fil = ~done & (tag == ID_FIL)
        done = done | ~(dse | fil)
        align = bits(p + 7, 1)
        count = bits(p + 8, 8)
        q = p + 16
        big = count == 255
        count = torch.where(big, count + bits(q, 8), count)
        q = torch.where(big, q + 8, q)
        q = torch.where(align != 0, (q + 7) & ~7, q)
        p_dse = q + 8 * count
        fcount = bits(p + 3, 4)
        fq = p + 7
        fbig = fcount == 15
        fcount = torch.where(fbig, fcount + bits(fq, 8) - 1, fcount)
        fq = torch.where(fbig, fq + 8, fq)
        p = torch.where(dse, p_dse, torch.where(fil, fq + 8 * fcount, p))
    return torch.where(done, p, -1)


def elem_head_plain(words, base, prev, end_a, end_b, status_in, k: int, num_samples: int,
                    max_order: int = MAX_ORDER, last: bool = False):
    """Plain torch version of :func:`elem_head`."""
    B, W = words.shape
    S = num_samples
    dev = words.device
    bits = _fields(words, W)
    base64 = base.to(I64)
    elements = base64[COL_ELEMENTS] & 0xFFFFFFFF
    nel = element_count(elements)
    status = torch.zeros(B, dtype=I64, device=dev) if status_in is None else status_in.to(I64)
    n0 = torch.clamp(base64[2], 0, S)
    active = (status == 0) & (k <= nel)

    pst = prev[0].to(I64) != 0
    pcomp = prev[1].to(I64) != 0
    pn = torch.clamp(prev[2].to(I64), 0, S)
    p = torch.where(pcomp, torch.where(pst, end_b.to(I64), end_a.to(I64)),
                    prev[8].to(I64) + pn * prev[3].to(I64) * torch.where(pst, 2, 1))
    p = _skip_aux(bits, p)
    tag = torch.where(p < 0, ID_DSE, bits(p, 3))
    at_end = active & (k == nel)
    status = torch.where(at_end & (tag != ID_END), 1, status)
    elem = active & (k < nel)
    want = element_kind(elements, k)
    tag_ok = torch.where(want == 2, tag == ID_CPE, (tag == ID_SCE) | (tag == ID_LFE))
    status = torch.where(elem & ~tag_ok, 1, status)
    parsed = elem & tag_ok
    stereo = parsed & (want == 2)
    nch = torch.where(stereo, 2, 1)
    hassize = bits(p + 19, 1)
    u = bits(p + 20, 2)
    comp = parsed & (bits(p + 22, 1) == 0)
    q = p + 23
    nraw = torch.where(hassize != 0, bits(q, 32), base64[COL_FRAME])
    q = q + 32 * hassize
    n = torch.clamp(nraw, 0, S)
    status = torch.where(parsed & (n != pn), 1, status)
    shift = torch.where(comp & stereo, bits(q, 8), 0)
    lw = torch.where(comp & stereo, bits(q + 8, 8), 0)
    c = torch.where(comp, q + 16, q)
    hm4 = base64[COL_HIST_MULT4]
    order = torch.zeros((2, B), dtype=I64, device=dev)
    quant = torch.zeros_like(order)
    mult = torch.zeros_like(order)
    rc = torch.zeros((2, MAX_ORDER + 1, B), dtype=I64, device=dev)
    t = torch.arange(MAX_ORDER + 1, device=dev)[:, None]
    for h in range(2):
        on = comp & (h < nch)
        ptype = bits(c, 4)
        status = torch.where(on & (ptype != 0) & (status == 0), 2, status)
        quant[h] = torch.where(on, bits(c + 4, 4), 0)
        mult[h] = torch.where(on, (bits(c + 8, 3) * hm4) & 0xFFFFFFFF, 0)
        o = torch.where(on, bits(c + 11, 5), 0)
        order[h] = o
        take = on[None, :] & (o < MAX_ORDER)[None, :] & (t >= 1) & (t <= o[None, :])
        v = bits(c[None, :] + 16 + 16 * (o[None, :] - t), 16)
        rc[h] = torch.where(take, torch.where(v >= 1 << 15, v - (1 << 16), v), 0)
        c = torch.where(on, c + 16 + 16 * o, c)
    ss = base64[3]
    ub = torch.where(comp, u, 0)
    rss = torch.where(comp, ss - 8 * u + stereo.to(I64), ss + stereo.to(I64))
    entropy = c + torch.where(comp, n * 8 * ub * nch, 0)

    keep = parsed & (status == 0)  # a refused lane runs no stage
    stereo, comp = stereo & keep, comp & keep

    def z(x):
        return torch.where(keep, x, 0)

    if last:
        return None, None, torch.where(status != 0, -status, n0).to(I32)
    n, ub, rss, shift, lw = z(n), z(ub), z(rss), z(shift), z(lw)
    payload, entropy = z(c), z(entropy)
    order, quant, mult = z(order), z(quant), z(mult)
    rc = torch.where(keep, rc, 0)
    coff = torch.where(keep, sum(element_kind(elements, e) for e in range(k)), -1)
    ncomp = torch.where(comp, n, 0)
    bn1 = torch.where(comp, 8 * ub, ss)
    wide = (order > max_order) & (order != MAX_ORDER)
    wide_a = torch.where(wide[0], ncomp, 0)
    wide_b = torch.where(stereo & wide[1], ncomp, 0)
    rows = torch.cat([
        torch.stack([stereo.to(I64), comp.to(I64), n, ss, ub, rss, shift, lw, payload,
                     entropy, base64[10], base64[11], base64[12]]),
        order, quant, mult, rc.reshape(2 * (MAX_ORDER + 1), B),
        torch.stack([torch.where(wide[0], 0, ncomp),
                     torch.where(stereo & ~wide[1], ncomp, 0),
                     torch.where(comp, torch.where(ub > 0, n, 0), n), bn1,
                     torch.where(stereo, bn1, 0), wide_a, wide_b, coff, status]),
    ]).to(I32)
    flags = torch.stack([stereo, comp, wide_a > 0, wide_b > 0])
    return rows, flags, None


def elem_head(
    words: torch.Tensor,  # (B, W) int32 word rows
    base: torch.Tensor,  # (N_CHAINED, B) int32: element 0's rows, chain columns
    prev: torch.Tensor,  # (>= 83, B) int32: the previous element's rows
    end_a: torch.Tensor,  # (B,) int32 its channel A's end bit
    end_b: torch.Tensor,  # (B,) int32 its channel B's (or where B would start)
    status_in: torch.Tensor | None,  # (B,) int32 lanes refused so far, or None
    k: int,  # the element (1 .. the lanes' element count)
    num_samples: int,
    max_order: int = MAX_ORDER,  # the narrow rice_lpc launch's order bucket
    last: bool = False,
    kernel: str = "auto",
):
    """Parse element ``k`` of each lane's frame -> (rows (ROWS, B) int32,
    flags (4, B) bool, None).

    ``last``: the pass after every lane's last element (the END check)
    -> (None, None, n_out (B,) int32): each lane's sample count, or
    -status where a pass refused it.
    """
    if not _lib.use_kernel(words, kernel):
        return elem_head_plain(words, base, prev, end_a, end_b, status_in, k, num_samples,
                               max_order, last)
    B, W = words.shape
    if W <= 0 or k < 1:
        raise ValueError(f"elem_head: bad shape B={B} W={W} k={k}")
    dev = words.device
    _lib.check_i32("words", words, (B, W), dev)
    _lib.check_i32("base", base, (N_CHAINED, B), dev)
    if prev.dtype != torch.int32 or prev.device != dev or prev.shape[1] != B \
            or prev.shape[0] < N_PACKED or not prev.is_contiguous():
        raise ValueError(f"prev: expected contiguous (>= {N_PACKED}, {B}) int32 on {dev}")
    for name, t in (("end_a", end_a), ("end_b", end_b)):
        _lib.check_i32(name, t, (B,), dev)
    if status_in is not None:
        _lib.check_i32("status_in", status_in, (B,), dev)
    rows = flags = n_out = None
    if last:
        n_out = torch.empty((B,), dtype=I32, device=dev)
    else:
        rows = torch.empty((ROWS, B), dtype=I32, device=dev)
        flags = torch.empty((4, B), dtype=torch.bool, device=dev)
    _lib.launch(
        "alac_elem_head", dev, words.data_ptr(), B, W, base.data_ptr(), prev.data_ptr(),
        end_a.data_ptr(), end_b.data_ptr(),
        None if status_in is None else status_in.data_ptr(), k, num_samples, max_order,
        N_PACKED, N_CHAINED, ROWS, None if rows is None else rows.data_ptr(),
        None if flags is None else flags.data_ptr(),
        None if n_out is None else n_out.data_ptr(),
    )
    return rows, flags, n_out
