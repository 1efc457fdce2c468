"""The share of the traced window in which the cards sat idle while the
host's innermost range was the program's enqueue of a batch
(``alac.host.enqueue``: its staging, launches and the copy back issued)
or, under a mesh, of one shard's part of it
(``alac.host.enqueue.shard<i>``), in %, averaged over the cards.  None
without a trace or without idle time under those spans."""

LAYER = "host enqueue (stage, launch, copies issued)"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decode_msamples_per_s"
SPAN = "alac.host.enqueue"


def read(w):
    if w.trace is None:
        return None
    idle = sum(s for name, s in w.trace.idle_by_activity.items()
               if name == SPAN or name.startswith(SPAN + ".shard"))
    return 100.0 * idle / w.trace.window_s if idle else None
