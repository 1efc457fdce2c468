"""High-throughput batch decode API.

The counterpart of ``alacnet_tpu/batch.py``: ``decode_files`` pools the
coded frames of *all* inputs into shared device batches (each frame
carries its own cookie parameters, so 16/24-bit, mono/stereo and
different sample rates mix freely in one dispatch) and splits the
decoded lanes back per file; ``decode_resumable`` decodes one file in
chunks from a persisted ``DecodeCursor``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import BinaryIO, Iterable

import numpy as np

from .config import DecodeConfig, resolve
from .container import demux
from .parallel.pipeline import decode_blob


@dataclasses.dataclass
class DecodedAudio:
    """One file's decode result."""

    pcm: np.ndarray  # (N, channels) int16/int32
    sample_rate: int
    bits_per_sample: int
    channels: int
    path: str | None = None
    #: Frame indices that failed to parse (lenient mode only; their
    #: samples are omitted). Empty in strict mode.
    bad_frames: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )

    @property
    def num_samples(self) -> int:
        return int(self.pcm.shape[0])

    @property
    def duration_seconds(self) -> float:
        return self.num_samples / self.sample_rate

    def as_float(self, dtype=np.float32) -> np.ndarray:
        """PCM normalized to [-1, 1) floats: ``pcm / 2**(bits-1)``."""
        return (self.pcm / float(1 << (self.bits_per_sample - 1))).astype(dtype)


def _collect(stream: BinaryIO):
    """Parse the container and read the raw bytes once (zero-copy blob)."""
    info = demux.parse(stream)
    stream.seek(0)
    blob = np.frombuffer(stream.read(), np.uint8)
    return info, blob


def decode_streams(
    streams: Iterable[BinaryIO], strict: bool | None = None,
    device: str | None = None, config: DecodeConfig | None = None, mesh=None,
) -> list[DecodedAudio]:
    """Decode many open .m4a streams in pooled device batches.

    ``config`` (default ``DecodeConfig()``, which decodes on ``cuda``)
    with ``device``/``strict`` overrides.  ``strict=False`` skips (and
    reports) undecodable frames instead of raising.  ``mesh``
    (``parallel/mesh.Mesh``, overrides the device): shard every batch's
    lanes over its devices and streams (``decode_blob(mesh=)``).
    """
    if mesh is not None:
        device = str(mesh.devices[0])
    config = resolve(config, device=device, strict=strict)
    infos, spans = [], []
    blobs, all_offsets, all_sizes, all_params = [], [], [], []
    blob_base = 0
    total_frames = 0
    for stream in streams:
        info, blob = _collect(stream)
        infos.append(info)
        offsets = info.tables.frame_file_offsets()
        sizes = info.tables.frame_byte_sizes
        spans.append((total_frames, total_frames + len(offsets)))
        blobs.append(blob)
        all_offsets.append(offsets + blob_base)
        all_sizes.append(sizes)
        all_params.extend([info.params] * len(offsets))
        blob_base += blob.size
        total_frames += len(offsets)
    if not total_frames:
        return [
            DecodedAudio(
                pcm=np.zeros((0, info.num_channels_or_default()), np.int32),
                sample_rate=info.sample_rate_or_default(),
                bits_per_sample=info.bits_per_sample_or_default(),
                channels=info.num_channels_or_default(),
            )
            for info in infos
        ]
    max_s = max(i.params.max_samples_per_frame for i in infos)
    out, n, status = decode_blob(
        np.concatenate(blobs),
        np.concatenate(all_offsets),
        np.concatenate(all_sizes),
        all_params,
        max_s,
        config=config,
        mesh=mesh,
    )
    # Vectorized ragged assembly: one boolean compress per file.
    S = out.shape[1]
    valid = np.arange(S)[None, :] < n[:, None]  # (F, S)
    results = []
    for info, (lo, hi) in zip(infos, spans):
        nch = info.num_channels_or_default()
        if hi > lo:
            block = out[lo:hi, :, :nch]
            pcm = block.reshape(-1, nch)[valid[lo:hi].reshape(-1)]
            if (
                info.bits_per_sample_or_default() == 16
                and pcm.dtype != np.int16
            ):
                # A mixed 16/24-bit pool upcasts the pooled array to
                # int32 at concat; 16-bit files still ship int16.
                pcm = pcm.astype(np.int16)
            bad = np.flatnonzero(status[lo:hi]).astype(np.int64)
        else:
            pcm = np.zeros((0, nch), np.int32)
            bad = np.zeros(0, np.int64)
        results.append(
            DecodedAudio(
                pcm=pcm,
                sample_rate=info.sample_rate_or_default(),
                bits_per_sample=info.bits_per_sample_or_default(),
                channels=nch,
                bad_frames=bad,
            )
        )
    return results


def decode_files(
    paths: Iterable[str | os.PathLike], strict: bool | None = None,
    device: str | None = None, config: DecodeConfig | None = None, mesh=None,
) -> list[DecodedAudio]:
    """Decode many .m4a files in pooled device batches (``mesh`` as for
    :func:`decode_streams`)."""
    paths = list(paths)
    streams = [open(p, "rb") for p in paths]
    try:
        results = decode_streams(
            streams, strict=strict, device=device, config=config, mesh=mesh
        )
    finally:
        for s in streams:
            s.close()
    for r, p in zip(results, paths):
        r.path = os.fspath(p)
    return results


def decode_file(
    path: str | os.PathLike, strict: bool | None = None,
    device: str | None = None, config: DecodeConfig | None = None,
) -> DecodedAudio:
    """Decode a single .m4a file."""
    return decode_files([path], strict=strict, device=device, config=config)[0]


@dataclasses.dataclass
class DecodeCursor:
    """Resumable batch-job position: (file, next frame index).

    ALAC frames carry no inter-frame state, so a job checkpoints as a
    frame cursor and resumes with a table-driven seek — the same
    property behind ``AlacContext.set_position``.
    """

    path: str
    next_frame: int = 0

    @property
    def done(self) -> bool:
        return self.next_frame < 0


def decode_resumable(
    cursor: DecodeCursor, max_frames: int = 4096, strict: bool | None = None,
    device: str | None = None, config: DecodeConfig | None = None,
) -> tuple[DecodedAudio, DecodeCursor]:
    """Decode up to ``max_frames`` frames from the cursor position.

    Returns the decoded chunk and the advanced cursor (``done`` once the
    file is exhausted).  Work can stop and resume across processes with
    only the cursor persisted.  ``config``/``device``/``strict`` as for
    :func:`decode_streams`; past the last frame nothing is decoded and
    nothing launches.
    """
    config = resolve(config, device=device, strict=strict)
    with open(cursor.path, "rb") as f:
        info = demux.parse(f)
        offsets = info.tables.frame_file_offsets()
        sizes = info.tables.frame_byte_sizes
        lo = cursor.next_frame
        hi = min(lo + max_frames, len(offsets))
        # Read only this chunk's byte range (bounded memory + I/O).
        if hi > lo:
            lo_byte = int(offsets[lo:hi].min())
            hi_byte = int((offsets[lo:hi] + sizes[lo:hi]).max())
            f.seek(lo_byte)
            blob = np.frombuffer(f.read(hi_byte - lo_byte), np.uint8)
    nch = info.num_channels_or_default()
    pcm = np.zeros((0, nch), np.int32)
    status = np.zeros(0, np.int32)
    if hi > lo:
        out, n, status = decode_blob(
            blob, offsets[lo:hi] - lo_byte, sizes[lo:hi], info.params,
            info.params.max_samples_per_frame, config=config,
        )
        valid = np.arange(out.shape[1])[None, :] < n[:, None]
        pcm = out[:, :, :nch].reshape(-1, nch)[valid.reshape(-1)]
    result = DecodedAudio(
        pcm=pcm,
        sample_rate=info.sample_rate_or_default(),
        bits_per_sample=info.bits_per_sample_or_default(),
        channels=nch,
        path=cursor.path,
        bad_frames=np.flatnonzero(status).astype(np.int64) + lo,
    )
    nxt = DecodeCursor(cursor.path, hi if hi < len(offsets) else -1)
    return result, nxt
