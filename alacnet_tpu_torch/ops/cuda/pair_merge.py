"""The encoder's pair merge, and with it the quad merge, as one kernel.

The counterpart of ``merge_pair_chunks`` and ``merge_quad_chunks`` of
the JAX package's ``ops/encode.py``, which XLA fuses under ``jit``
outside any Pallas kernel.  Kernel 9 of the encode path
(``csrc/pair_merge.cu``): one pass over the chunk planes that
``enc_rice`` writes (sample-major (S, B) storage, taken through its
(B, S) views at any strides), a block a tile of 32 lanes by 64 samples
staged through shared memory, the pair planes and, with ``quads``, the
quad planes written lane-major and contiguous (so the host's copies of
them need no transpose on the card), the per-lane ``fat``/``qfat``
flags set in the same launch.  The plain versions are
``ops/encode.merge_pair_chunks`` and ``merge_quad_chunks``.
"""

from __future__ import annotations

import torch

from ..encode import merge_pair_chunks, merge_quad_chunks
from . import _lib

#: Samples of a row that a block covers (``kTile``): the grid's y axis.
SAMPLES_PER_BLOCK = 64


def merge_pair_chunks_plain(c0, c1, c2, ws, quads: bool = False):
    """Plain torch version of :func:`merge_pair_chunks_fused`."""
    pairs = merge_pair_chunks(c0, c1, c2, ws)
    if quads:
        return (*pairs, *merge_quad_chunks(*pairs[:4]))
    return pairs


def merge_pair_chunks_fused(
    c0: torch.Tensor,  # (B, S) int32 high words
    c1: torch.Tensor,  # (B, S) int32
    c2: torch.Tensor,  # (B, S) int32 low words
    ws: torch.Tensor,  # (B, S) int8 widths
    quads: bool = False,
    kernel: str = "auto",
):
    """:func:`merge_pair_chunks` and, with ``quads``,
    :func:`merge_quad_chunks` of its output, in one launch.

    Returns (ph, pm, pl (B, P) int32, pws (B, P) int8, fat (B,) bool),
    P = ceil(S/2); with ``quads`` followed by (qh, qm, ql (B, Q) int32,
    qws (B, Q) int8, qfat (B,) bool), Q = ceil(P/2).  On the kernel
    route every plane is lane-major and contiguous.
    """
    dev = c0.device
    if c0.dim() != 2:
        raise ValueError(f"merge_pair_chunks_fused: expected (B, S) planes, got {tuple(c0.shape)}")
    B, S = c0.shape
    # One expression for the common case (a check costs microseconds a
    # call on the host); the loop names the offending plane.
    if not (c0.dtype == c1.dtype == c2.dtype == torch.int32 and ws.dtype == torch.int8
            and c0.shape == c1.shape == c2.shape == ws.shape
            and c1.device == c2.device == ws.device == dev):
        for name, x, dtype in (("c0", c0, torch.int32), ("c1", c1, torch.int32),
                               ("c2", c2, torch.int32), ("ws", ws, torch.int8)):
            if x.dtype != dtype or x.device != dev or x.shape != c0.shape:
                raise ValueError(f"{name}: expected {dtype} {(B, S)} on {dev}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not _lib.use_kernel(c0, kernel):
        return merge_pair_chunks_plain(c0, c1, c2, ws, quads)
    strides = c0.stride()
    if c1.stride() != strides or c2.stride() != strides:
        raise ValueError("c0, c1 and c2 must share their strides")
    if min(*strides, *ws.stride()) < 0 or -(-S // SAMPLES_PER_BLOCK) > _lib.MAX_GRID_Y:
        raise ValueError(f"merge_pair_chunks_fused: bad strides or shape S={S} B={B}")
    P = -(-S // 2)
    Q = -(-P // 2)
    # The three word planes of a set in one buffer: (3, B, n) int32.
    sets = [(torch.empty((3, B, P), dtype=torch.int32, device=dev),
             torch.empty((B, P), dtype=torch.int8, device=dev))]
    if quads:
        sets.append((torch.empty((3, B, Q), dtype=torch.int32, device=dev),
                     torch.empty((B, Q), dtype=torch.int8, device=dev)))
    flags = torch.empty((len(sets), B), dtype=torch.bool, device=dev)
    ptrs = []
    for words, widths in sets:
        base, step = words.data_ptr(), words.stride(0) * 4
        ptrs += [base, base + step, base + 2 * step, widths.data_ptr()]
    if B:
        _lib.launch(
            "alac_pair_merge", dev, c0.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            ws.data_ptr(), *strides, *ws.stride(), B, S, int(quads),
            *ptrs, *(None,) * (8 - len(ptrs)), flags.data_ptr(),
        )
    out = ()
    for (words, widths), flag in zip(sets, flags.unbind(0)):
        out += (*words.unbind(0), widths, flag)
    return out
