"""The share of the traced window in which the cards sat idle while the
host's innermost range was the launching of the element chain of frames of
3-8 channels (``alac.host.element_chain``, inside a batch's enqueue: each
later element's header kernel and the launches it feeds), in %,
averaged over the cards.  None without a trace or without idle time
under that span (a program without it, or a pool without such frames)."""

LAYER = "element chain (multichannel frames)"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decode_msamples_per_s"
SPAN = "alac.host.element_chain"


def read(w):
    if w.trace is None:
        return None
    idle = w.trace.idle_by_activity.get(SPAN, 0.0)
    return 100.0 * idle / w.trace.window_s if idle else None
