"""``bulk_bits``'s share of its roofline over the traced window: the least
time of the work the window's frames need (``yardstick.bulk_bits_work``,
counted from the inputs) over the summed device time of its kernels."""

from benchmark import yardstick

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "decode_msamples_per_s"


def read(w):
    return yardstick.roofline_pct(w, yardstick.bulk_bits_work, "bulk_bits_kernel")
