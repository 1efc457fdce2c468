"""The share of the window the host spent in the program's plan-and-parse
spans (``alac.host.parse``, summed into ``GLOBAL_STATS.host_seconds``)."""

LAYER = "host plan and parse"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decode_msamples_per_s"


def read(w):
    return 100.0 * w.stats["host_seconds"] / w.seconds
