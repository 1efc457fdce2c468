"""The decode epilogue: from the decoded channel planes to PCM.

The counterpart of the elementwise end of the JAX package's
``ops/frame_decode._decode_frames_impl``, which XLA fuses into one loop
under ``jit`` (no Pallas kernel there).  Kernel 7 of the decode path
(``csrc/dec_epilogue.cu``): one pass over the planes, a block a tile of
32 lanes by 64 samples, the compressed planes staged through shared
memory (they arrive as the rice_lpc kernel's sample-major storage), the
others read and the output written with 16-byte accesses where the
rows allow.  The plain version is :func:`decode_epilogue_plain`, a
chain of torch ops.

A plane the caller knows to be absent (no lane has a channel B, no
extra bits, no raw frame) is passed as ``None``: the kernel reads it
as zeros and the plain version fills in a zero plane.
"""

from __future__ import annotations

import torch

from ..bitops import I32, shl, signext, sra
from . import _lib

#: Samples of a row that a block of the kernel covers (``kTile``).
SAMPLES_PER_BLOCK = 64


def extend_raw(v, sample_size):
    """Raw-sample sign extension: plain for ss<=16, the reference's
    hard-coded 24-bit (x ^ m) - m form for ss>16 (:512-521)."""
    ss = sample_size
    le16 = signext(v, ss[:, None])
    mbit = 1 << 23
    gt16 = ((v & 0xFFFFFF) ^ mbit) - mbit
    return torch.where((ss <= 16)[:, None], le16, gt16)


def decode_epilogue_plain(
    out_a, out_b, extra_a, extra_b, raw_a, raw_b, is_stereo, is_compressed,
    sample_size, ub, interlacing_shift, interlacing_leftweight, n,
    num_samples: int, emit16: bool = False, channels: int = 2, out=None,
    channel_offset=None,
):
    """Plain torch version of :func:`decode_epilogue`."""
    S = num_samples
    B = n.shape[0]
    dev = n.device

    def zeros():
        return torch.zeros((B, S), dtype=I32, device=dev)

    out_a = zeros() if out_a is None else out_a
    out_b = zeros() if out_b is None else out_b
    extra_a = zeros() if extra_a is None else extra_a
    extra_b = zeros() if extra_b is None else extra_b
    raw_a = zeros() if raw_a is None else extend_raw(raw_a, sample_size)
    raw_b = zeros() if raw_b is None else extend_raw(raw_b, sample_size)
    comp = is_compressed
    c2 = comp[:, None]
    a = torch.where(c2, out_a, raw_a)
    b = torch.where(c2, out_b, raw_b)

    # ---- decorrelation (:338-421); C# masks shift counts & 31 ----
    lw = torch.where(comp, interlacing_leftweight, 0)[:, None]
    sh = torch.where(comp, interlacing_shift, 0)[:, None] & 31
    right_w = a - sra(b * lw, sh)
    left_w = right_w + b
    use_w = (lw != 0) & is_stereo[:, None]
    left = torch.where(use_w, left_w, a)
    right = torch.where(use_w, right_w, b)

    # ---- extra-bits merge (:381-395,549-554): 24-bit output paths only
    ub8 = torch.where(comp, ub * 8, 0)[:, None]
    mask = shl(torch.full_like(ub8, -1), ub8) ^ -1
    has_extra = (ub8 > 0) & (sample_size > 16)[:, None]
    left = torch.where(has_extra, shl(left, ub8) | (extra_a & mask), left)
    right = torch.where(
        has_extra & is_stereo[:, None], shl(right, ub8) | (extra_b & mask),
        right,
    )

    # 24-bit output is a 3-byte layout (Deinterlace24 truncates each
    # value to its low 24 bits, AlacFile.cs:390-395,558-562).
    is24 = (sample_size > 16)[:, None]
    left = torch.where(is24, sra(shl(left, 8), 8), left)
    right = torch.where(is24, sra(shl(right, 8), 8), right)

    # mono lanes: silent channel 1 (:536-540,563-565); mask the tail.
    live = torch.arange(S, dtype=I32, device=dev)[None, :] < n[:, None]
    left = torch.where(live, left, 0)
    right = torch.where(live & is_stereo[:, None], right, 0)
    dtype = torch.int16 if emit16 else I32
    if channel_offset is None:
        pair = torch.stack([left, right], dim=-1).to(dtype)
        if channels == 2:
            return pair
        out = torch.zeros((B, S, channels), dtype=dtype, device=dev)
        out[:, :, :2] = pair
        return out
    lanes = torch.nonzero(channel_offset >= 0).reshape(-1)
    at = channel_offset[lanes].long()[:, None]
    cols = torch.arange(S, device=dev)[None, :]
    out[lanes[:, None], cols, at] = left[lanes].to(dtype)
    pairs = lanes[is_stereo[lanes]]
    at = channel_offset[pairs].long()[:, None] + 1
    out[pairs[:, None], cols, at] = right[pairs].to(dtype)
    return out


def _plane(name: str, x, B: int, S: int, dev, sample_major_ok: bool):
    """(plane or None, is it sample-major (S, B) storage) for the kernel:
    the plane as given where its layout is one the kernel reads, else a
    contiguous (B, S) copy."""
    if x is None:
        return None, False
    if tuple(x.shape) != (B, S):
        raise ValueError(f"{name}: expected shape {(B, S)}, got {tuple(x.shape)}")
    if sample_major_ok and x.t().is_contiguous():
        _lib.check_i32(name, x.t(), (S, B), dev)
        return x, True
    x = x.contiguous()
    _lib.check_i32(name, x, (B, S), dev)
    return x, False


def decode_epilogue(
    out_a: torch.Tensor | None,  # (B, S) int32 compressed channel A
    out_b: torch.Tensor | None,  # (B, S) int32 compressed channel B
    extra_a: torch.Tensor | None,  # (B, S) int32 extra bits, channel A
    extra_b: torch.Tensor | None,
    raw_a: torch.Tensor | None,  # (B, S) int32 raw fields (unextended)
    raw_b: torch.Tensor | None,
    is_stereo: torch.Tensor,  # (B,) bool
    is_compressed: torch.Tensor,  # (B,) bool
    sample_size: torch.Tensor,  # (B,) int32
    ub: torch.Tensor,  # (B,) int32 extra bytes per sample
    interlacing_shift: torch.Tensor,  # (B,) int32
    interlacing_leftweight: torch.Tensor,  # (B,) int32
    n: torch.Tensor,  # (B,) int32 samples kept, in [0, S]
    num_samples: int,
    emit16: bool = False,
    kernel: str = "auto",
    channels: int = 2,
    out: torch.Tensor | None = None,
    channel_offset: torch.Tensor | None = None,
) -> torch.Tensor:
    """Final PCM: (B, S, channels) int32, or int16 (the low 16 bits)
    under ``emit16``.

    Compressed lanes take ``out_a``/``out_b``, the others the raw
    fields sign-extended; then the stereo decorrelation, the extra-bits
    merge, the 24-bit wrap; channel 1 is zero for mono lanes and every
    sample at i >= n is zero.  ``None`` planes read as zeros.

    ``channels`` above 2 (a pool of frames of up to 8 channels): each
    lane's channels 0 and 1 as above, the others zero.
    ``channel_offset`` ((B,) int32; then ``out`` is that output, which
    is written into and returned): a later element of such frames, each
    lane's channel (or pair, for a stereo lane) written at its offset
    and nothing else; a lane whose offset is negative is left alone.
    """
    if channel_offset is not None and out is None:
        raise ValueError("decode_epilogue: channel_offset needs out")
    if not _lib.use_kernel(n, kernel):
        return decode_epilogue_plain(
            out_a, out_b, extra_a, extra_b, raw_a, raw_b, is_stereo,
            is_compressed, sample_size, ub, interlacing_shift,
            interlacing_leftweight, n, num_samples, emit16, channels, out,
            channel_offset,
        )
    B = n.shape[0]
    S = num_samples
    if S < 0 or B * max(S, 1) >= 1 << 31 or S > _lib.MAX_GRID_Y * SAMPLES_PER_BLOCK:
        raise ValueError(f"decode_epilogue: bad shape B={B} S={S}")
    dev = n.device
    out_a, a_sm = _plane("out_a", out_a, B, S, dev, True)
    out_b, b_sm = _plane("out_b", out_b, B, S, dev, True)
    lane_major = [_plane(k, x, B, S, dev, False)[0] for k, x in (
        ("extra_a", extra_a), ("extra_b", extra_b), ("raw_a", raw_a), ("raw_b", raw_b))]
    for name, t in (("is_stereo", is_stereo), ("is_compressed", is_compressed)):
        if t.dtype != torch.bool or t.device != dev or tuple(t.shape) != (B,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous ({B},) bool on {dev}")
    cols = (sample_size, ub, interlacing_shift, interlacing_leftweight, n)
    for name, t in zip(("sample_size", "ub", "interlacing_shift",
                        "interlacing_leftweight", "n"), cols):
        _lib.check_i32(name, t, (B,), dev)
    dtype = torch.int16 if emit16 else I32
    if channels < 2:
        raise ValueError(f"decode_epilogue: channels={channels}")
    if channel_offset is None:
        out = torch.empty((B, S, channels), dtype=dtype, device=dev)
    else:
        _lib.check_i32("channel_offset", channel_offset, (B,), dev)
        if out.dtype != dtype or out.device != dev or tuple(out.shape) != (B, S, channels) \
                or not out.is_contiguous():
            raise ValueError(f"out: expected a contiguous ({B}, {S}, {channels}) {dtype}")
    if B and S:
        _lib.launch(
            "alac_dec_epilogue", dev,
            *(None if x is None else x.data_ptr() for x in (out_a, out_b)),
            int(a_sm), int(b_sm),
            *(None if x is None else x.data_ptr() for x in lane_major),
            is_stereo.data_ptr(), is_compressed.data_ptr(),
            *(t.data_ptr() for t in cols), B, S, int(emit16), channels,
            None if channel_offset is None else channel_offset.data_ptr(), out.data_ptr(),
        )
    return out
