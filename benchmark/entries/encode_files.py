"""Entry ``encode_files``: whole tracks of seeded PCM through
``alacnet_tpu_torch.encode_files`` into `.m4a`, the tracks of a request
pooled in one call, every output written to ``io.BytesIO``.

Set-up makes the library's PCM from the seed (``inputs/library.py``).
The reference codes every distinct frame of the library with the frozen
encoder (``inputs/alac.py``) at the mix's encoder settings and muxes
each track with the frozen muxer (``inputs/m4a.py``): an encoded track
is right when every byte of its file equals the reference's.
"""

from __future__ import annotations

import dataclasses
import io

import numpy as np

from ..inputs import alac, library

#: The control codes each sample with its low byte dropped.
CONTROL_DROP_BITS = 8


@dataclasses.dataclass
class State:
    lib: library.Library
    pcms: list
    encoder: dict
    device: str
    config: object = None
    control_files: list | None = None

    @property
    def tracks(self) -> int:
        return len(self.lib.tracks)

    def track_samples(self, t: int) -> int:
        return self.lib.samples(t)


def prepare(ctx) -> State:
    from alacnet_tpu_torch import EncoderConfig

    lib = library.make_library(ctx.config, ctx.seed)
    pcms = [lib.track_pcm(t) for t in range(len(lib.tracks))]
    enc = dict(ctx.mix["encoder"])
    if ctx.config.get("uncompressed_bytes"):
        enc["uncompressed_bytes"] = ctx.config["uncompressed_bytes"]
    return State(lib, pcms, enc, ctx.devices[0], EncoderConfig(**enc))


def request(state: State, tracks) -> tuple[list, int]:
    """Encode the tracks in one call; returns each file's bytes and the
    samples (per channel) encoded."""
    from alacnet_tpu_torch import encode_files

    c = state.lib.config
    outs = [io.BytesIO() for _ in tracks]
    encode_files(
        [state.pcms[t] for t in tracks], outs, c["sample_rate"], c["bits_per_sample"],
        config=state.config, max_samples_per_frame=c["frame_samples"], device=state.device,
    )
    return [o.getvalue() for o in outs], sum(state.pcms[t].shape[0] for t in tracks)


def release(state: State) -> None:
    state.config = None


def _coding(state: State) -> alac.FrameCoding:
    c, e = state.lib.config, state.encoder
    if not e.get("adaptive_coefs", True):
        raise ValueError("the frozen encoder codes with per-frame Levinson coefficients only")
    return alac.FrameCoding(
        sample_size=c["bits_per_sample"], max_samples_per_frame=c["frame_samples"],
        quant=e["quant"], rice_modifier=e["rice_modifier"],
        interlacing_shift=e["interlacing_shift"],
        interlacing_leftweight=e["interlacing_leftweight"],
        uncompressed_bytes=e.get("uncompressed_bytes", 0),
        levinson_window=e["levinson_window"],
    )


def reference_files(state: State, drop_bits: int = 0) -> list:
    """Every track's `.m4a` bytes as the frozen encoder and muxer make them
    (``drop_bits``: from the PCM with that many low bits dropped)."""
    lib = state.lib
    if drop_bits:
        lib = dataclasses.replace(lib, pool_pcm=(lib.pool_pcm >> drop_bits) << drop_bits)
    coded = lib.code(_coding(state), orders=state.encoder["order"])
    return [lib.m4a(coded, t) for t in range(len(lib.tracks))]


def control(state: State, tracks) -> tuple[list, int]:
    """The reference in the program's place, at the precision below the
    configuration's: the PCM's low byte dropped before coding."""
    if state.control_files is None:
        state.control_files = reference_files(state, CONTROL_DROP_BITS)
    return ([state.control_files[t] for t in tracks],
            sum(state.pcms[t].shape[0] for t in tracks))


def check(state: State, records) -> dict:
    """``wrong_bytes``: over every file of every request, the bytes that
    differ from the reference's file; a missing or extra byte, and every
    byte of a file that never came back, counts as wrong."""
    refs = reference_files(state)
    wrong = 0
    for r in records:
        for i, t in enumerate(r.tracks):
            ref = np.frombuffer(refs[t], np.uint8)
            got = None if r.result is None or i >= len(r.result) else r.result[i]
            if got is None:
                wrong += ref.size
                continue
            got = np.frombuffer(got, np.uint8)
            common = min(got.size, ref.size)
            wrong += int(np.count_nonzero(got[:common] != ref[:common]))
            wrong += abs(got.size - ref.size)
    return {"wrong_bytes": (wrong, 0)}


def frames(state: State, records) -> library.Frames:
    tracks = [t for r in records for t in r.tracks]
    return library.frames_of(state.lib, tracks, state.encoder["order"])
