"""Entry ``decode_surround``: whole 5.1 `.m4a` tracks through
``alacnet_tpu_torch.decode_streams``, one request's tracks pooled in one
call, as ``decode_streams`` (the entry) drives it.

Set-up makes the library from the seed (``inputs/surround.py``: the
stereo library's plan with six channels, every frame the chain of
elements of Apple's 5.1 map, coded by the frozen encoder), each track
muxed into `.m4a` bytes with the ``chan`` record, held in host memory.
The request, the control, the check and the counts are
``decode_streams``': a decoded track is right when every sample of every
channel, and its sample count, channels, bit depth and rate, equal the
source's.
"""

from __future__ import annotations

from ..inputs import surround
from .decode_streams import State, check, control, frames, release, request

__all__ = ["prepare", "request", "control", "check", "frames", "release"]


def prepare(ctx) -> State:
    lib = surround.make_library(ctx.config, ctx.seed)
    coded = surround.code(lib)
    files = [surround.m4a_of(lib, coded, t) for t in range(len(lib.tracks))]
    return State(lib, coded, files, ctx.devices[0])
