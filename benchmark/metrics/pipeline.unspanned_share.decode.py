"""The share of the traced window in which the cards sat idle under no
span of the program: the host inside the harness's own ranges
(``bench.request``, ``bench.window``) or in none, in %, averaged over the
cards.  It guards the program's span shares: work moved out from under
the spans shows here.  None without a trace or without such idle time."""

LAYER = "none: card idle time no program span names"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "decode_msamples_per_s"
SPANS = ("bench.request", "bench.window", "outside any span")


def read(w):
    if w.trace is None:
        return None
    idle = sum(s for name, s in w.trace.idle_by_activity.items() if name in SPANS)
    return 100.0 * idle / w.trace.window_s if idle else None
