"""The share of the traced window in which the cards sat idle while the
host's innermost range was the program's demux (``alac.host.demux``: each
stream's container parse and read, and the pooling of every file's frames
into one blob), in %, averaged over the cards.  None without a trace or
without idle time under the span."""

LAYER = "entry, demux and pooling"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decode_msamples_per_s"
SPANS = ("alac.host.demux",)


def read(w):
    if w.trace is None:
        return None
    idle = sum(s for name, s in w.trace.idle_by_activity.items() if name in SPANS)
    return 100.0 * idle / w.trace.window_s if idle else None
