"""Seeded PCM, frozen for the benchmark.

The port's bench generator (``bench_lib._music_pcm``: three sinusoids
and a little noise, 12% of full scale) with its parameters drawn per
frame from the seed: the level, the pitch of the three partials, the
noise and the phase.  24-bit material adds ``dither`` of uniform noise
in the low bits, as the bench's ``hires24`` kind does, so the low byte
carries about nine bits of unpredictable content.
"""

from __future__ import annotations

import numpy as np


def music_frames(count: int, frame_samples: int, bits: int, channels: int, rng,
                 dither: int = 0) -> np.ndarray:
    """(count, frame_samples, channels) int32 PCM, each frame its own
    seeded excerpt."""
    lim = 1 << (bits - 1)
    t = rng.uniform(0, 1 << 24, (count, 1)) + np.arange(frame_samples)[None, :]
    level = lim * rng.uniform(0.06, 0.18, (count, 1))
    pitch = rng.uniform(0.7, 1.4, (count, 1))
    noise = rng.uniform(0.005, 0.015, (count, 1))
    chans = []
    for c in range(channels):
        sig = (
            level * np.sin(t * 0.013 * pitch + c)
            + 0.5 * level * np.sin(t * 0.0913 * pitch + 2.7 * c)
            + 0.1 * level * np.sin(t * 0.537 * pitch)
            + rng.normal(0.0, 1.0, t.shape) * level * noise
        )
        chans.append(sig)
    pcm = np.stack(chans, axis=2)
    if dither:
        pcm = pcm + rng.integers(-dither, dither, pcm.shape)
    return np.clip(pcm, -lim, lim - 1).astype(np.int32)
