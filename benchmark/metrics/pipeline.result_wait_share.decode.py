"""The share of the window the host spent blocked on the PCM's copy back
(the program's ``alac.device.result_wait`` spans, summed into
``GLOBAL_STATS.result_wait_seconds``)."""

LAYER = "PCM way back (D2H and its wait)"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "decode_msamples_per_s"


def read(w):
    return 100.0 * w.stats["result_wait_seconds"] / w.seconds
