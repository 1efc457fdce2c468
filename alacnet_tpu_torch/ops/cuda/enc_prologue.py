"""The encoder's prologue: interleaved PCM -> the sample-major signal.

The counterpart of the elementwise head of the JAX package's
``ops/encode.encode_stages_pcm``, which XLA fuses under ``jit`` into the
automaton prologue (no Pallas kernel there).  Kernel 11 of the encode
path (``csrc/enc_prologue.cu``): the extra-bits strip, the stereo
decorrelation and the channel fold in one pass, a block a tile of 32
frames by 64 samples staged through shared memory, written straight into
the (S, 2F) sample-major storage that the ``enc_pred`` kernel reads, so
that no transposing copy follows.  The plain version is
:func:`encode_prologue_plain`, a chain of torch ops.
"""

from __future__ import annotations

import torch

from ..bitops import I32, I64, wrap32
from . import _lib

#: Samples of a frame that a block covers (``kTile``): the grid's y axis.
SAMPLES_PER_BLOCK = 64


def encode_prologue_plain(pcm, stereo, lw: int = 0, sh: int = 0, ub8: int = 0,
                          wide: bool = False) -> torch.Tensor:
    """Plain torch version of :func:`encode_prologue_fused`: the folded
    (2F, S) int32 signal, lane f channel A of frame f, lane F + f its
    channel B."""
    hi = (pcm >> ub8) if ub8 else pcm
    l_ch, r_ch = hi[:, :, 0], hi[:, :, 1]
    if lw != 0:
        cb = l_ch - r_ch
        if wide:
            adj = wrap32((cb.to(I64) * lw) >> sh)
        else:
            adj = (cb * lw) >> sh
        ca = r_ch + adj
    else:
        ca, cb = l_ch, r_ch
    st = stereo[:, None]
    return torch.cat(
        [torch.where(st, ca, l_ch).to(I32), torch.where(st, cb, 0).to(I32)]
    )


def encode_prologue_fused(
    pcm: torch.Tensor,  # (F, S, 2) int32 interleaved PCM
    stereo: torch.Tensor,  # (F,) bool
    lw: int = 0,
    sh: int = 0,
    ub8: int = 0,
    wide: bool = False,
    kernel: str = "auto",
) -> torch.Tensor:
    """The folded signal as (S, 2F) int32 sample-major storage: its
    ``.t()`` is the (2F, S) signal of :func:`encode_prologue_plain`.

    ``ub8``: extra bits stripped (``pcm >> ub8``); ``lw``/``sh``: the
    decorrelation's leftweight and shift (``lw == 0``: none); ``wide``:
    the product in int64 (post-strip widths over 16 bits).  On the
    plain route the result is the transposed view of the plain version's
    (2F, S) tensor.
    """
    if not _lib.use_kernel(pcm, kernel):
        return encode_prologue_plain(pcm, stereo, lw, sh, ub8, wide).t()
    if pcm.dim() != 3 or pcm.shape[2] != 2:
        raise ValueError(f"encode_prologue: expected (F, S, 2) PCM, got {tuple(pcm.shape)}")
    F, S = pcm.shape[:2]
    if (sh < 0 or ub8 < 0 or not -(1 << 31) <= lw < 1 << 31
            or 2 * F * max(S, 1) >= 1 << 31 or -(-S // SAMPLES_PER_BLOCK) > _lib.MAX_GRID_Y):
        raise ValueError(f"encode_prologue: bad arguments F={F} S={S} lw={lw} sh={sh} "
                         f"ub8={ub8}")
    dev = pcm.device
    _lib.check_i32("pcm", pcm, (F, S, 2), dev)
    if stereo.dtype != torch.bool or stereo.device != dev or tuple(stereo.shape) != (F,) \
            or not stereo.is_contiguous():
        raise ValueError(f"stereo: expected a contiguous ({F},) bool on {dev}")
    out = torch.empty((S, 2 * F), dtype=I32, device=dev)
    if F and S:
        # A count past the type's width fills with the sign bit, as
        # torch's shifts do: the same as the width less one.
        _lib.launch(
            "alac_enc_prologue", dev, pcm.data_ptr(), stereo.data_ptr(), F, S, lw,
            min(sh, 63 if wide else 31), min(ub8, 31), int(wide), out.data_ptr(),
        )
    return out
