"""Decoded samples a second: the per-channel samples (``DecodedAudio.
num_samples``) of every request completed in the window, over the
window's seconds (from the first request's call to the last's return)."""

UNIT = "Msamples/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(w):
    return sum(r.samples for r in w.requests) / w.seconds / 1e6
