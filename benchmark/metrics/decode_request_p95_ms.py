"""The 95th percentile of the latency of every request in the window,
from call to return (linear interpolation between order statistics)."""

import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(w):
    if not w.requests:
        return None
    return float(np.percentile([r.seconds for r in w.requests], 95)) * 1e3
