"""AlacContext — the session facade (decode side of the public API).

The counterpart of ``alacnet_tpu/context.py``, which mirrors the C#
reference's only public decoder class (AlacContext.cs:20-338): construct
over a seekable stream, query metadata (with the reference's
44100/2/16-bit defaults), read decoded PCM frame-at-a-time, and seek
sample-accurately.

Differences from the reference, by design (as in the JAX package):
  * decoding happens in batched device windows (the port's
    ``parallel/pipeline.decode_blob`` on ``config.device``) instead of
    one frame per call — ``read()`` still returns one frame's bytes at a
    time, but the card decodes ``window`` frames per dispatch, and a
    one-slot readahead decodes the next window on a worker thread;
  * ``set_position`` is sample-accurate for 24-bit too;
  * sample tables are consulted via prefix sums, not per-frame stts
    walks.
"""

from __future__ import annotations

import contextlib
import threading
from typing import BinaryIO

import numpy as np
import torch

from .config import DecodeConfig, resolve
from .container import demux
from .errors import SampleReadError
from .pcm import format_pcm_bytes


class AlacContext:
    """Decode session over one `.m4a` stream.

    ``config`` (default ``DecodeConfig()``, which decodes on ``cuda`` and
    raises without a card) with a ``device`` override; ``window`` frames
    per device window (default ``config.stream_window``).
    """

    def __init__(
        self,
        stream: BinaryIO,
        dispose_stream: bool = False,
        window: int | None = None,
        device: str | None = None,
        config: DecodeConfig | None = None,
    ):
        self._config = resolve(config, device=device)
        dev = self._config.torch_device
        if dev.type == "cuda" and dev.index is None:
            # Pin the card now: the readahead thread's current device
            # need not be the caller's.
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self._stream = stream
        self._dispose_stream = dispose_stream
        self._window = max(
            1, window if window is not None else self._config.stream_window
        )
        self.info = demux.parse(stream)  # raises HeaderError like the ctor
        self._tables = self.info.tables
        self._offsets = self._tables.frame_file_offsets()
        self._sizes = self._tables.frame_byte_sizes
        self._current_sample_block = 0
        self._offset_samples = 0  # leading samples to trim after a seek
        self.last_sample_number = 0  # AlacContext.cs:76
        self._cache_first = -1
        self._cache_out: np.ndarray | None = None
        self._cache_n: np.ndarray | None = None
        self._lock = threading.Lock()
        # One-slot readahead: (first_frame, Future) for the window the
        # sequential reader will want next (VERDICT r2 next #10).
        self._prefetch: tuple[int, object] | None = None
        self._executor = None
        #: Windows served by the readahead (a window decoded ahead on the
        #: worker thread and then read).
        self.prefetch_hits = 0

    # -- metadata getters (AlacContext.cs:83-122) ---------------------------

    def get_sample_rate(self) -> int:
        return self.info.sample_rate_or_default()

    def get_num_channels(self) -> int:
        return self.info.num_channels_or_default()

    def get_bits_per_sample(self) -> int:
        return self.info.bits_per_sample_or_default()

    def get_bytes_per_sample(self) -> int:
        return self.info.bytes_per_sample_or_default()

    def get_num_samples(self) -> int:
        """Total PCM samples, or -1 if the tables are inconsistent."""
        return self._tables.num_samples()

    @property
    def num_frames(self) -> int:
        return self._tables.num_frames

    # -- decode window management -------------------------------------------

    def _read_window_bytes(self, first: int):
        """Read the coded bytes of frames [first, first+window).

        Stream IO stays on the CALLER's thread (the prefetch worker only
        ever decodes an already-read blob), so the reposition lock's
        guarantees are untouched.
        """
        hi = min(first + self._window, self.num_frames)
        offs = self._offsets[first:hi].astype(np.int64)
        sizes = self._sizes[first:hi].astype(np.int64)
        lo_byte = int(offs.min())
        hi_byte = int((offs + sizes).max())
        payload_bytes = int(sizes.sum())
        span = hi_byte - lo_byte
        if span <= max(4 * payload_bytes, 1 << 20):
            self._stream.seek(lo_byte)
            blob = np.frombuffer(self._stream.read(span), np.uint8)
            blob_offs = offs - lo_byte
        else:
            # Sparse layout (interleaved tracks / large chunk gaps): a
            # span read would pull the gaps into memory too.  Assemble a
            # compact blob with one read per frame instead.
            blob = np.empty(payload_bytes, np.uint8)
            blob_offs = np.concatenate(([0], np.cumsum(sizes)))[:-1]
            for f in range(hi - first):
                self._stream.seek(int(offs[f]))
                chunk = self._stream.read(int(sizes[f]))
                blob[int(blob_offs[f]) : int(blob_offs[f]) + len(chunk)] = (
                    np.frombuffer(chunk, np.uint8)
                )
        return blob, blob_offs, sizes

    def _decode_window_blob(self, blob, blob_offs, sizes):
        """Decode one window's blob on the session's device (on either
        thread: the caller's, or the readahead worker's)."""
        from .parallel.pipeline import decode_blob

        params = self.info.params
        on_card = (
            torch.cuda.device(self._device) if self._device.type == "cuda"
            else contextlib.nullcontext()
        )
        with on_card:
            out, n, _ = decode_blob(
                blob, blob_offs, sizes, params, params.max_samples_per_frame,
                config=self._config,
            )
        return out, n

    def _decode_window(self, first: int) -> None:
        """Decode frames [first, first+window) through the blob path.

        One contiguous-span read + the native parse/pack pipeline
        (parallel.pipeline.decode_blob) instead of a per-frame Python
        seek/read loop — frames of a window are adjacent in mdat except
        across chunk gaps, so a single [min, max) span read covers them.

        Sequential reads get READAHEAD: after serving window k this
        dispatches window k+1 on a one-slot worker, so the device (and
        the parse pipeline) works on the next window while the caller
        consumes this one instead of idling between windows.
        """
        if self._prefetch is not None and self._prefetch[0] == first:
            _, fut = self._prefetch
            self._prefetch = None
            out, n = fut.result()
            self.prefetch_hits += 1
        else:
            out, n = self._decode_window_blob(*self._read_window_bytes(first))
        self._cache_first = first
        self._cache_out = out
        self._cache_n = n
        nxt = first + self._window
        if nxt < self.num_frames and (
            self._prefetch is None or self._prefetch[0] != nxt
        ):
            if self._executor is None:
                import concurrent.futures

                self._executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="alac-readahead"
                )
            args = self._read_window_bytes(nxt)
            self._prefetch = (
                nxt,
                self._executor.submit(self._decode_window_blob, *args),
            )

    def _frame_samples(self, frame: int) -> np.ndarray:
        """Decoded (n, channels) int32 samples of one frame."""
        if not (
            self._cache_first >= 0
            and self._cache_first <= frame < self._cache_first + self._window
        ):
            self._decode_window(frame)
        i = frame - self._cache_first
        nch = self.get_num_channels()
        return self._cache_out[i, : self._cache_n[i], :nch]

    # -- streaming read (AlacContext.cs:163-204) -----------------------------

    def read_frame(self) -> np.ndarray:
        """Decode the next frame -> (n, channels) int32 (empty at EOF).

        Applies the post-seek leading-sample trim (AlacContext.cs:200-202)
        and advances ``last_sample_number`` by the frame's stts duration
        (AlacContext.cs:199).
        """
        with self._lock:
            block = self._current_sample_block
            if block >= self.num_frames:
                return np.zeros((0, self.get_num_channels()), np.int32)
            try:
                duration = self._tables.frame_duration(block)
            except SampleReadError:
                # Park at EOF: the reference's stts walk failure yields a
                # 0-byte read and its caller stops (AlacContext.cs:182-193).
                # Without advancing, read_all() on an stts-undercovered
                # file would spin forever re-reading the same frame.
                self._current_sample_block = self.num_frames
                return np.zeros((0, self.get_num_channels()), np.int32)
            samples = self._frame_samples(block)
            self._current_sample_block = block + 1
            self.last_sample_number += int(duration)
            if self._offset_samples:
                samples = samples[self._offset_samples :]
                self._offset_samples = 0
            return samples

    def read(self) -> bytes:
        """Decode the next frame -> little-endian PCM bytes ('' at EOF)."""
        samples = self.read_frame()
        if samples.size == 0:
            return b""
        return format_pcm_bytes(samples, self.get_bytes_per_sample())

    def read_all(self) -> np.ndarray:
        """Decode from the current position to EOF -> (N, channels) int32."""
        parts = []
        while True:
            s = self.read_frame()
            if s.size == 0 and self._current_sample_block >= self.num_frames:
                break
            parts.append(s)
        nch = self.get_num_channels()
        if not parts:
            return np.zeros((0, nch), np.int32)
        return np.concatenate(parts)

    # -- seek (AlacContext.cs:262-295) ----------------------------------------

    def set_position(self, position: int, clamp_to_eof: bool = False) -> None:
        """Seek to an absolute PCM sample position.

        By default past-EOF positions leave the state unchanged, like the
        reference's walk running off the table end (AlacContext.cs:266-294
        — subsequent reads then continue from the *old* position).
        ``clamp_to_eof=True`` instead parks at end-of-stream so the next
        read returns empty (the io-protocol behavior ALACFileReader.seek
        needs).
        """
        with self._lock:
            frame, _, start, end = self._tables.locate_pcm_sample(int(position))
            if frame >= self.num_frames:
                if clamp_to_eof:
                    self._current_sample_block = self.num_frames
                    self.last_sample_number = end
                    self._offset_samples = 0
                return
            self._current_sample_block = frame
            self.last_sample_number = end
            self._offset_samples = int(position) - start

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        if self._executor is not None:
            # Wait for an in-flight window: no worker may go on launching
            # on the card after the session is closed.
            self._executor.shutdown(wait=True, cancel_futures=True)
            self._executor = None
        self._prefetch = None
        if self._dispose_stream:
            self._stream.close()

    dispose = close  # reference naming (AlacContext.cs:297-318)

    def __enter__(self) -> "AlacContext":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
