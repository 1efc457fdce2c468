"""Entry ``decode_streams``: whole `.m4a` tracks of the library through
``alacnet_tpu_torch.decode_streams``, the tracks of a request pooled in
one call, on one card or (``mesh_cards`` in the mix) over a mesh of
cards.

Set-up makes the library from the seed (``inputs/library.py``): the pool
coded by the frozen encoder, each track muxed into `.m4a` bytes held in
host memory.  A request opens each of its tracks as ``io.BytesIO`` and
decodes them.  The reference is the PCM the library was made from: a
decoded track is right when every sample, and its sample count,
channels, bit depth and rate, equal the source's.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np

from ..inputs import library

#: The control drops the low byte of every sample: 8-bit for 16-bit
#: material, 16-bit for 24-bit (the extra-bits channel left out).
CONTROL_DROP_BITS = 8


@dataclasses.dataclass
class State:
    lib: library.Library
    coded: object
    files: list
    device: str
    mesh: object = None

    @property
    def tracks(self) -> int:
        return len(self.lib.tracks)

    def track_samples(self, t: int) -> int:
        return self.lib.samples(t)


def prepare(ctx) -> State:
    lib = library.make_library(ctx.config, ctx.seed)
    coded = lib.code()
    files = [lib.m4a(coded, t) for t in range(len(lib.tracks))]
    mesh = None
    cards = int(ctx.mix.get("mesh_cards", 0))
    if cards:
        from alacnet_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh(ctx.devices[:cards])
    return State(lib, coded, files, ctx.devices[0], mesh)


def request(state: State, tracks) -> tuple[list, int]:
    """Decode the tracks in one call; returns the results and the samples
    (per channel) they hold."""
    from alacnet_tpu_torch import decode_streams

    streams = [io.BytesIO(state.files[t]) for t in tracks]
    if state.mesh is not None:
        out = decode_streams(streams, mesh=state.mesh)
    else:
        out = decode_streams(streams, device=state.device)
    return out, sum(r.num_samples for r in out)


def release(state: State) -> None:
    state.mesh = None


@dataclasses.dataclass
class Answer:
    """A decoded track as the reference gives it (the control's answers)."""

    pcm: np.ndarray
    sample_rate: int
    bits_per_sample: int
    channels: int

    @property
    def num_samples(self) -> int:
        return int(self.pcm.shape[0])


def control(state: State, tracks) -> tuple[list, int]:
    """The reference in the program's place, at the precision below the
    configuration's: each sample's low byte dropped."""
    c = state.lib.config
    out = []
    for t in tracks:
        pcm = state.lib.track_pcm(t)
        pcm = (pcm >> CONTROL_DROP_BITS) << CONTROL_DROP_BITS
        out.append(Answer(pcm, c["sample_rate"], c["bits_per_sample"], c["channels"]))
    return out, sum(a.num_samples for a in out)


def check(state: State, records) -> dict:
    """``wrong_samples``: over every track of every request, the samples
    (one a channel) that differ from the source PCM; a missing or extra
    sample, and every sample of a track that never came back or came back
    with another channel count, bit depth or rate, counts as wrong."""
    c = state.lib.config
    refs: dict = {}
    wrong = 0
    for r in records:
        for i, t in enumerate(r.tracks):
            if t not in refs:
                refs[t] = state.lib.track_pcm(t)
            ref = refs[t]
            got = None if r.result is None or i >= len(r.result) else r.result[i]
            wrong += _wrong(got, ref, c)
    return {"wrong_samples": (wrong, 0)}


def _wrong(got, ref: np.ndarray, c: dict) -> int:
    if got is None or (got.channels, got.bits_per_sample, got.sample_rate) != (
            c["channels"], c["bits_per_sample"], c["sample_rate"]):
        return ref.size
    pcm = np.asarray(got.pcm).reshape(-1, ref.shape[1]) if got.pcm.size else got.pcm
    if pcm.ndim != 2 or pcm.shape[1] != ref.shape[1]:
        return ref.size
    common = min(pcm.shape[0], ref.shape[0])
    extra = abs(pcm.shape[0] - ref.shape[0]) * ref.shape[1]
    return int(np.count_nonzero(pcm[:common] != ref[:common])) + extra


def frames(state: State, records) -> library.Frames:
    tracks = [t for r in records for t in r.tracks]
    return library.frames_of(state.lib, tracks, state.coded.orders, state.coded.rice_bits)
