"""The share of the traced window in which the cards sat idle while the
host's innermost range was one of the program's uploads (``alac.host.h2d``:
the blob's host staging, upload and byteswap, once a card; each batch's
rows or words and its packed metadata), in %, averaged over the cards.
None without a trace or without idle time under the span."""

LAYER = "H2D, mesh shards"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decode_msamples_per_s"
SPANS = ("alac.host.h2d",)


def read(w):
    if w.trace is None:
        return None
    idle = sum(s for name, s in w.trace.idle_by_activity.items() if name in SPANS)
    return 100.0 * idle / w.trace.window_s if idle else None
