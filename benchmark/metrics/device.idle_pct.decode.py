"""The share of the traced window in which no operation ran on the
card (``TraceData.idle_pct``), in the cells that report the decode rate."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "decode_msamples_per_s"


def read(w):
    return None if w.trace is None else w.trace.idle_pct()
