"""Device-side row assembly: the (B, W) word-row table from the raw blob.

The counterpart of ``alacnet_tpu/ops/pallas/pack_rows.py``.  The host
ships the raw coded blob to the device once, as a zero-copy
little-endian word view (``host_le_words``); ``blob_words`` byte-swaps
it there into the big-endian word domain of the bit readers (kernel 10,
``csrc/blob_words.cu``, through :func:`blob_words_fused`), and
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

from ...utils.transfer import h2d, pin
from . import _lib

#: Minor dimension of the (Nq, 128) blob layout (kept from the JAX
#: package, so the blob tensors of the two packages compare equal).
QL = 128
#: Padding granularity of the blob, in words.
ALIGN = 1024
#: Words of a row one block of the kernel writes (``kChunk``).
ROW_CHUNK = 1024


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


def blob_words_plain(x: torch.Tensor, tail_be: int, nq: int) -> torch.Tensor:
    """Plain torch version of :func:`blob_words_fused` (``_words_from_le``
    of the JAX package): a byteswap in int32 ops, a zero fill, the
    swapped words copied in and the tail word filled in."""
    be = (
        ((x & 0xFF) << 24)
        | ((x & 0xFF00) << 8)
        | ((x >> 8) & 0xFF00)
        | ((x >> 24) & 0xFF)
    )
    out = torch.zeros(nq * QL, dtype=torch.int32, device=x.device)
    out[: x.shape[0]] = be
    # a fill, not a scalar copy from the host: CUDA graphs can capture it
    out[x.shape[0] : x.shape[0] + 1].fill_(_i32(tail_be))
    return out.view(nq, QL)


def _i32(v: int) -> int:
    """A uint32 value as its int32 bit pattern."""
    return v - (1 << 32) if v >= 1 << 31 else v


def blob_words_fused(
    x: torch.Tensor, tail_be: int, nq: int, kernel: str = "auto"
) -> torch.Tensor:
    """Device half of :func:`blob_words`: the uploaded little-endian
    words ``x`` (m,) int32 -> (nq, 128) int32 big-endian words: word
    i < m is ``bswap(x[i])``, word m the tail word ``tail_be``, every
    later word 0.  On the kernel route one launch of
    ``csrc/blob_words.cu`` writes every output word."""
    if not _lib.use_kernel(x, kernel):
        return blob_words_plain(x, tail_be, nq)
    m = x.shape[0]
    total = nq * QL
    if x.dim() != 1 or not m < total or not 0 <= tail_be < 1 << 32:
        raise ValueError(f"blob_words: need {m} words < {total} and a uint32 tail, "
                         f"got shape {tuple(x.shape)}, tail {tail_be}")
    dev = x.device
    _lib.check_i32("x", x, (m,), dev)
    out = torch.empty((nq, QL), dtype=torch.int32, device=dev)
    _lib.launch(
        "alac_blob_words", dev, x.data_ptr() if m else None, m, _i32(tail_be),
        total, out.data_ptr(),
    )
    return out


def blob_words(
    blob_u8: np.ndarray, device, max_w: int = 0, kernel: str = "auto"
) -> torch.Tensor:
    """Byte blob -> (Nq, 128) big-endian words (int32 patterns) on
    ``device``: one H2D copy of the little-endian view, then the
    byteswap and padding there (:func:`blob_words_fused`)."""
    return blob_words_uploader(blob_u8, max_w, kernel)(device)


def blob_words_uploader(blob_u8: np.ndarray, max_w: int = 0, kernel: str = "auto"):
    """:func:`blob_words` for several devices (``Mesh.replicated``): a
    function of the device whose calls share one host staging of the
    blob, a single pinned copy that every card uploads from."""
    w32, tail_be, nq = host_le_words(blob_u8, max_w)
    w32 = w32.view(np.int32)
    staged: list = []

    def make(device) -> torch.Tensor:
        device = torch.device(device)
        if device.type != "cuda":
            x = h2d(w32, device)
        else:
            if not staged:
                staged.append(pin(w32))
            x = staged[0].to(device, non_blocking=True)
        return blob_words_fused(x, tail_be, nq, kernel=kernel)

    return make


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
    if not 0 < W <= L or L >= 1 << 31 or W > _lib.MAX_GRID_Y * ROW_CHUNK:
        raise ValueError(f"pack_rows: need 0 < W <= {L} < 2**31, got W={W}")
    dev = bwords.device
    _lib.check_i32("bwords", bwords, tuple(bwords.shape), dev)
    for name, t in (("ow", ow), ("nbytes", nbytes)):
        _lib.check_i32(name, t, (B,), dev)
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    # 16-byte copies need 16-byte rows on both sides (the main path's W
    # is a multiple of 256 words); any other shape moves word by word.
    src = bwords.data_ptr()
    vec4 = W % 4 == 0 and L % 4 == 0 and src % 16 == 0
    _lib.launch(
        "alac_pack_rows", dev, src, L, ow.data_ptr(),
        nbytes.data_ptr(), B, W, int(vec4), out.data_ptr(),
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
