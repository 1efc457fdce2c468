"""A seeded music library of whole tracks, from a configuration file.

A track is a sequence of frames: a lead-in of digital silence, music,
a run-out of silence, and a last frame that holds what is left of the
track's length.  Each music frame is drawn from a pool of distinct
seeded excerpts (``pcm.music_frames``), coded once by the frozen encoder
(``alac.encode_frames``); ALAC frames are independent, so a track of
pool frames is coded exactly as a track coded whole.  The sizes are the
same for every seed: the track lengths and the silences are fixed
quantiles of the configuration's ranges, and the seed deals them out,
draws the excerpts and which pool frame stands where.  The encoder codes
each channel of each pool frame at the cheaper of the configuration's
candidate orders.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import alac, m4a, pcm


@dataclasses.dataclass
class Library:
    """The tracks of one configuration and seed, before any coding."""

    config: dict
    #: (P, S, C) int32 PCM of every pool entry, zero past its length
    pool_pcm: np.ndarray
    pool_n: np.ndarray  # (P,) samples of each entry
    tracks: list  # per track, the (frames,) pool indices in play order

    def samples(self, t: int) -> int:
        return int(self.pool_n[self.tracks[t]].sum())

    def track_pcm(self, t: int) -> np.ndarray:
        """(samples, C) PCM of track ``t``: int16 at 16 bits, else int32."""
        f = self.tracks[t]
        C = self.pool_pcm.shape[2]
        out = self.pool_pcm[f].reshape(-1, C)[: self.samples(t)]
        # only the last frame may be short, so the slice drops its padding
        return out.astype(np.int16 if self.config["bits_per_sample"] == 16 else np.int32)

    def coding(self) -> alac.FrameCoding:
        c = self.config
        return alac.FrameCoding(
            sample_size=c["bits_per_sample"], max_samples_per_frame=c["frame_samples"],
            uncompressed_bytes=c.get("uncompressed_bytes", 0),
        )

    def code(self, coding: alac.FrameCoding | None = None, orders=None) -> alac.Coded:
        """Every pool entry coded by the frozen encoder, each channel at the
        cheaper of the configuration's orders (``orders``: at these)."""
        return alac.encode_frames(
            self.pool_pcm, self.pool_n,
            tuple(self.config["orders"]) if orders is None else orders, coding or self.coding(),
        )

    def m4a(self, coded: alac.Coded, t: int) -> bytes:
        """Track ``t`` as a whole `.m4a` file of ``coded``'s frames."""
        c = self.config
        f = self.tracks[t]
        return m4a.write_m4a(
            c["sample_rate"], c["bits_per_sample"], c["channels"], c["frame_samples"],
            [coded.payloads[i] for i in f], self.pool_n[f].tolist(),
        )


def quantiles(lo: float, hi: float, k: int) -> np.ndarray:
    """``k`` evenly spaced mid-points of [lo, hi]: the same sizes for every seed."""
    return lo + (np.arange(k) + 0.5) * (hi - lo) / k


def make_library(config: dict, seed: int) -> Library:
    """Plan the library of ``config`` for ``seed`` (PCM and frame order;
    nothing is coded yet)."""
    rng = np.random.default_rng([seed % (1 << 64), 0])
    S = int(config["frame_samples"])
    rate = int(config["sample_rate"])
    C = int(config["channels"])
    T = int(config["tracks"])
    M = int(config["pool_frames"])
    lengths = np.round(quantiles(*config["track_seconds"], T) * rate).astype(np.int64)
    silences = quantiles(*config["silence_seconds"], T)
    lengths = lengths[rng.permutation(T)]
    lead = np.round(silences[rng.permutation(T)] * rate / S).astype(np.int64)
    trail = np.round(silences[rng.permutation(T)] * rate / S).astype(np.int64)

    music = pcm.music_frames(M, S, config["bits_per_sample"], C, rng,
                             dither=int(config.get("dither", 0)))
    entries = [music]
    n = [np.full(M, S)]
    silence = M  # one full silent frame
    entries.append(np.zeros((1, S, C), np.int32))
    n.append(np.full(1, S))
    tracks = []
    next_entry = M + 1
    tails = []
    for t in range(T):
        total = -(-int(lengths[t]) // S)
        tail = int(lengths[t]) - (total - 1) * S
        m = total - 1 - lead[t] - trail[t]
        if m <= 0:
            raise ValueError(f"track {t}: {lengths[t]} samples leave no music frame")
        silent = lambda k: np.full(k, silence)  # noqa: E731
        last = silent(1)
        if tail < S:
            last = np.array([next_entry])
            tails.append(tail)
            next_entry += 1
        tracks.append(np.concatenate([
            silent(lead[t]), rng.integers(0, M, m), silent(trail[t]), last,
        ]).astype(np.int64))
    if tails:
        entries.append(np.zeros((len(tails), S, C), np.int32))
        n.append(np.asarray(tails))
    return Library(
        config=config,
        pool_pcm=np.concatenate(entries),
        pool_n=np.concatenate(n).astype(np.int64),
        tracks=tracks,
    )


@dataclasses.dataclass
class Frames:
    """What the yardstick counts a kernel's work from: each frame's live
    samples, and per channel its predictor order and Rice section bits."""

    n: np.ndarray
    orders: np.ndarray  # (F, C)
    rice_bits: np.ndarray  # (F, C); zeros where no one counted them
    channels: int
    uncompressed_bytes: int


def frames_of(lib: Library, tracks, orders, rice_bits=None) -> Frames:
    """The frames of the given tracks (a track as often as it is given):
    ``orders`` one for all or (P, C) per pool entry and channel, as
    ``Coded.orders``; ``rice_bits`` (P, C) likewise, or zeros."""
    idx = np.concatenate([lib.tracks[t] for t in tracks]) if len(tracks) else np.zeros(0, np.int64)
    C = int(lib.config["channels"])
    orders = np.broadcast_to(np.asarray(orders, np.int64), (lib.pool_n.size, C))
    bits = np.zeros((lib.pool_n.size, C), np.int64) if rice_bits is None else rice_bits
    return Frames(
        n=lib.pool_n[idx], orders=np.asarray(orders)[idx], rice_bits=bits[idx], channels=C,
        uncompressed_bytes=int(lib.config.get("uncompressed_bytes", 0)),
    )
