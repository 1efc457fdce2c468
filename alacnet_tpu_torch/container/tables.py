"""Vectorized MP4 sample-table math (stts / stsz / stsc / stco).

The reference walks these tables with per-sample linear scans:
``TryGetSampleInfo`` re-walks stts from the start for every frame
(AlacContext.cs:130-156, called per frame at :187 — O(n^2) across a file)
and ``SetPosition`` walks stsc x stco x samples (AlacContext.cs:262-295).
Here every query is a NumPy prefix-sum + searchsorted, which is also what
hands the device pipeline its per-frame byte offsets up front (the property
that makes ALAC frames embarrassingly parallel, SURVEY.md §2.5).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..errors import SampleReadError


@dataclasses.dataclass(frozen=True)
class SampleTables:
    """Immutable sample-table bundle for one audio track.

    Replaces the mutable ``DemuxResT`` DTO fields (DemuxResT.cs:16-35):
      - ``frame_byte_sizes``  <- SampleByteSize (stsz)
      - ``stts_counts/durations`` <- TimeToSample (stts)
      - ``stsc_first_chunk/samples_per_chunk`` <- Stsc
      - ``chunk_offsets`` <- Stco
    """

    frame_byte_sizes: np.ndarray  # (F,) int64 — coded bytes per ALAC frame
    stts_counts: np.ndarray  # (T,) int64 — frames covered by each stts entry
    stts_durations: np.ndarray  # (T,) int64 — PCM samples per frame in entry
    stsc_first_chunk: np.ndarray  # (C,) int64 — 1-based first chunk index
    stsc_samples_per_chunk: np.ndarray  # (C,) int64 — frames per chunk
    chunk_offsets: np.ndarray  # (K,) int64 — absolute file offsets (stco)

    # -- derived (cached) --------------------------------------------------

    def __post_init__(self):
        # Frame index at which each stts entry starts, plus total coverage.
        starts = np.concatenate(([0], np.cumsum(self.stts_counts)))
        object.__setattr__(self, "_stts_frame_starts", starts)
        # Per-frame PCM duration, expanded; frames beyond stts coverage are
        # invalid (reference returns null -> 0-byte read, AlacContext.cs:148-152).
        object.__setattr__(
            self, "_frame_offsets_cache", None
        )

    @property
    def num_frames(self) -> int:
        return int(self.frame_byte_sizes.shape[0])

    # -- stts --------------------------------------------------------------

    def frame_durations(self) -> np.ndarray:
        """(F,) PCM samples contributed by each frame.

        Equivalent to calling TryGetSampleInfo for every frame
        (AlacContext.cs:130-156) but in one vectorized pass.  Raises
        SampleReadError if any frame lacks stts coverage, mirroring
        GetNumSamples' -1 path (AlacContext.cs:108-122).
        """
        if self.num_frames == 0:
            # Empty stream: GetNumSamples sums over zero entries -> 0
            # (AlacContext.cs:108-122).
            return np.zeros(0, dtype=np.int64)
        starts = self._stts_frame_starts
        covered = int(starts[-1])
        if self.num_frames > covered or len(self.stts_counts) == 0:
            raise SampleReadError(
                f"{self.num_frames - covered} frame(s) lack stts coverage"
            )
        idx = np.searchsorted(starts, np.arange(self.num_frames), side="right") - 1
        return self.stts_durations[idx]

    def frame_duration(self, frame: int) -> int:
        """Duration of a single frame; raises if uncovered.

        Scalar twin of :meth:`frame_durations` (TryGetSampleInfo,
        AlacContext.cs:130-156).
        """
        if frame < 0 or frame >= self.num_frames:
            raise SampleReadError(f"sample {frame} does not exist")
        starts = self._stts_frame_starts
        if frame >= starts[-1]:
            raise SampleReadError(f"sample {frame} does not have a duration")
        idx = int(np.searchsorted(starts, frame, side="right")) - 1
        return int(self.stts_durations[idx])

    def num_samples(self) -> int:
        """Total PCM samples, or -1 when unknown (AlacContext.cs:108-122)."""
        try:
            return int(self.frame_durations().sum())
        except SampleReadError:
            return -1

    def frame_pcm_starts(self) -> np.ndarray:
        """(F+1,) exclusive prefix sum of frame durations (seek index)."""
        return np.concatenate(([0], np.cumsum(self.frame_durations())))

    # -- stsc / stco -------------------------------------------------------

    def frames_per_chunk(self) -> np.ndarray:
        """(K,) frames in each chunk, expanding the stsc run-length form.

        stsc rows are (first_chunk, samples_per_chunk, desc_index); a row
        applies until the next row's first_chunk (AlacContext.cs:266-273).
        """
        num_chunks = len(self.chunk_offsets)
        if num_chunks == 0:
            return np.zeros(0, dtype=np.int64)
        if len(self.stsc_first_chunk) == 0:
            raise SampleReadError("missing stsc table")
        per_chunk = np.zeros(num_chunks, dtype=np.int64)
        bounds = np.concatenate(
            (self.stsc_first_chunk, [num_chunks + 1])
        ).astype(np.int64)
        for i, spc in enumerate(self.stsc_samples_per_chunk):
            lo = int(bounds[i]) - 1  # chunks are 1-based
            hi = min(int(bounds[i + 1]) - 1, num_chunks)
            per_chunk[lo:hi] = spc
        # No chunk can hold more frames than the stream has: a corrupt
        # stsc samples_per_chunk u32 (fuzz: 2.1e9) would otherwise drive
        # multi-GB expansions in frame_file_offsets' np.repeat.
        return np.minimum(per_chunk, max(0, self.num_frames))

    def frame_file_offsets(self) -> np.ndarray:
        """(F,) absolute file offset of each coded ALAC frame.

        The reference only derives offsets during seek (SetPosition's
        stsc->stco walk accumulating stsz, AlacContext.cs:262-295); for
        batch decode we need them all, so: chunk base (stco) + prefix sum
        of stsz within the chunk.
        """
        if self._frame_offsets_cache is not None:
            return self._frame_offsets_cache
        per_chunk = self.frames_per_chunk()
        total = int(per_chunk.sum())
        nframes = self.num_frames
        if nframes == 0:
            empty = np.zeros(0, np.int64)
            object.__setattr__(self, "_frame_offsets_cache", empty)
            return empty
        if total < nframes:
            raise SampleReadError(
                f"chunk tables cover {total} frames, stsz has {nframes}"
            )
        # Chunk index of each frame — searchsorted over the per-chunk
        # prefix sums rather than np.repeat: the repeat materializes
        # sum(per_chunk) elements, which a hostile stsc/stsz pair can
        # push to a petabyte-scale allocation (MemoryError escaping the
        # AlacError contract) even with per-entry clamps.
        chunk_of_frame = np.searchsorted(
            np.cumsum(per_chunk), np.arange(nframes, dtype=np.int64),
            side="right",
        )
        sizes = self.frame_byte_sizes.astype(np.int64)
        csum = np.concatenate(([0], np.cumsum(sizes)))[:-1]  # bytes before frame
        # bytes before the first frame of each chunk
        chunk_starts_frames = np.concatenate(
            ([0], np.cumsum(per_chunk))
        )[:-1]
        chunk_starts_frames = np.minimum(chunk_starts_frames, nframes)
        bytes_before_chunk = csum[np.minimum(chunk_starts_frames, nframes - 1)]
        bytes_before_chunk = np.where(
            chunk_starts_frames < nframes, bytes_before_chunk, 0
        )
        offsets = (
            self.chunk_offsets[chunk_of_frame]
            + csum[:nframes]
            - bytes_before_chunk[chunk_of_frame]
        )
        object.__setattr__(self, "_frame_offsets_cache", offsets)
        return offsets

    # -- seek ---------------------------------------------------------------

    def locate_pcm_sample(self, position: int) -> tuple[int, int, int, int]:
        """Map a PCM sample position to (frame, file_offset, frame_pcm_start,
        pcm_position_after_frame).

        Vectorized equivalent of ``AlacContext.SetPosition``
        (AlacContext.cs:262-295): finds the frame whose PCM span brackets
        ``position``.  Returns the frame index, its coded byte offset, the
        PCM sample index at which it starts, and the PCM index just past it
        (the reference's ``currentPosition`` / LastSampleNumber value).
        """
        starts = self.frame_pcm_starts()
        if position >= starts[-1]:
            # Past EOF: reference leaves state unchanged (loop runs off the
            # end); callers decide. Signal with frame == num_frames.
            return self.num_frames, -1, int(starts[-1]), int(starts[-1])
        frame = int(np.searchsorted(starts, position, side="right")) - 1
        offsets = self.frame_file_offsets()
        return (
            frame,
            int(offsets[frame]),
            int(starts[frame]),
            int(starts[frame + 1]),
        )
