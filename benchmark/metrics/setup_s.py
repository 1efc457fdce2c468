"""Set-up: from the process's start to the first timed request: imports,
the program's kernels built or loaded, the inputs made from the seed and
the warm-up requests."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(w):
    return w.setup_s
