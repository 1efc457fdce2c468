"""Device-side row assembly: the (B, W) word-row table from the raw blob.

The counterpart of ``alacnet_tpu/ops/pallas/pack_rows.py``.  The host
ships the raw coded blob to the device once, as a zero-copy
little-endian word view (``host_le_words``); ``blob_words`` byte-swaps
it there into the big-endian word domain of the bit readers, and
``pack_rows`` (kernel 1, ``csrc/pack_rows.cu``) cuts each lane's row out
of it, zeroing every byte at or after the frame's end.

A frame's first byte may sit anywhere in a word: the caller keeps
``ow = byte_offset >> 2`` and adds ``8 * (byte_offset & 3)`` to the
lane's start bit positions (``host_row_params``).  Words carry int32 bit
patterns.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.transfer import h2d
from . import _lib

#: Minor dimension of the (Nq, 128) blob layout (kept from the JAX
#: package, so the blob tensors of the two packages compare equal).
QL = 128
#: Padding granularity of the blob, in words.
ALIGN = 1024


def host_le_words(
    blob_u8: np.ndarray, max_w: int = 0
) -> tuple[np.ndarray, int, int]:
    """Host half of ``blob_words``: a zero-copy little-endian uint32
    view of the blob (plus the <=3 tail bytes folded into one big-endian
    word) and the padded row count.

    ``max_w``: the widest row the caller will ever gather.  Padding is
    ``max_w + 2*ALIGN`` zero words past the blob, so a tail frame's row
    in a wide span reads zero bits past the blob end, never a clipped
    (wrongly based) window.
    """
    blob_u8 = np.asarray(blob_u8, dtype=np.uint8)
    n = blob_u8.shape[0]
    n4 = (n // 4) * 4
    head = blob_u8[:n4]
    if not (head.flags.c_contiguous and head.flags.aligned):
        head = np.ascontiguousarray(head)
    try:
        w32 = head.view(np.uint32)
    except ValueError:  # misaligned base (offset slice into a buffer)
        w32 = np.frombuffer(head.tobytes(), np.uint32)
    tail_be = 0
    for i, b in enumerate(blob_u8[n4:]):
        tail_be |= int(b) << (24 - 8 * i)
    nw = -(-n // 4)
    nq = -(-(nw + max_w + 2 * ALIGN) // ALIGN) * ALIGN // QL
    return w32, tail_be, nq


def blob_words(blob_u8: np.ndarray, device, max_w: int = 0) -> torch.Tensor:
    """Byte blob -> (Nq, 128) big-endian words (int32 patterns) on
    ``device``: one H2D copy of the little-endian view, then a byteswap
    in int32 ops there."""
    w32, tail_be, nq = host_le_words(blob_u8, max_w)
    x = h2d(w32.view(np.int32), torch.device(device))
    be = (
        ((x & 0xFF) << 24)
        | ((x & 0xFF00) << 8)
        | ((x >> 8) & 0xFF00)
        | ((x >> 24) & 0xFF)
    )
    out = torch.zeros(nq * QL, dtype=torch.int32, device=x.device)
    out[: x.shape[0]] = be
    out[x.shape[0]] = tail_be - (1 << 32) if tail_be >= 1 << 31 else tail_be
    return out.view(nq, QL)


def _mask_tail(rows: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """Zero every byte of ``rows`` (B, W) at/after per-lane ``nbytes``."""
    j = torch.arange(rows.shape[1], dtype=torch.int32, device=rows.device)
    nb = torch.clamp(nbytes[:, None] - 4 * j[None, :], 0, 4)
    # nb==4 -> keep all; nb==0 -> zero; else keep the top nb bytes.
    mask = torch.where(
        nb >= 4, -1, torch.where(nb <= 0, 0, -1 << ((4 - nb) * 8))
    )
    return rows & mask


def pack_rows_plain(
    bwords: torch.Tensor, ow: torch.Tensor, nbytes: torch.Tensor, W: int
) -> torch.Tensor:
    """Plain torch version (``pack_rows_xla`` of the JAX package)."""
    flat = bwords.reshape(-1)
    ow = torch.clamp(ow, 0, flat.shape[0] - W).to(torch.int64)
    idx = ow[:, None] + torch.arange(W, device=flat.device)[None, :]
    return _mask_tail(flat[idx], nbytes)


def pack_rows(
    bwords: torch.Tensor, ow: torch.Tensor, nbytes: torch.Tensor, W: int,
    kernel: str = "auto",
) -> torch.Tensor:
    """(B, W) int32 rows: row b = flat ``bwords[ow[b] : ow[b]+W]`` with
    every byte at/after ``nbytes[b]`` zeroed.  ``bwords`` from
    ``blob_words`` (its padding keeps every window in bounds)."""
    if not _lib.use_kernel(bwords, kernel):
        return pack_rows_plain(bwords, ow, nbytes, W)
    B = ow.shape[0]
    L = bwords.numel()
    if not 0 < W <= L or L >= 1 << 31 or W > _lib.MAX_GRID_Y * 256:
        raise ValueError(f"pack_rows: need 0 < W <= {L} < 2**31, got W={W}")
    _lib.check_i32("bwords", bwords, tuple(bwords.shape), bwords.device)
    for name, t in (("ow", ow), ("nbytes", nbytes)):
        _lib.check_i32(name, t, (B,), bwords.device)
    out = torch.empty((B, W), dtype=torch.int32, device=bwords.device)
    _lib.launch(
        "alac_pack_rows", bwords.data_ptr(), L, ow.data_ptr(),
        nbytes.data_ptr(), B, W, out.data_ptr(),
    )
    return out


def host_row_params(
    offsets: np.ndarray, sizes: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-lane (ow, nbytes, start_bit_bump) for device packing.

    ow = byte offset >> 2; nbytes = in-row valid bytes (sub-word shift +
    frame size); start_bit_bump = 8 * (byte offset & 3), to add to the
    parsed start bit position (which is relative to the frame's first
    byte).
    """
    off = offsets.astype(np.int64)
    sh = (off & 3).astype(np.int32)
    ow = (off >> 2).astype(np.int32)
    nbytes = (sh + sizes.astype(np.int64)).astype(np.int32)
    return ow, nbytes, (8 * sh).astype(np.int32)
