"""Encoded samples a second: the per-channel samples of the PCM of every
request completed in the window, over the window's seconds."""

UNIT = "Msamples/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(w):
    return sum(r.samples for r in w.requests) / w.seconds / 1e6
