"""``enc_rice``'s share of its roofline over the traced window: the least
time of the work the window's frames need (``yardstick.enc_rice_work``,
counted from the inputs) over the summed device time of its kernels."""

from benchmark import yardstick

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "encode_msamples_per_s"


def read(w):
    return yardstick.roofline_pct(w, yardstick.enc_rice_work, "ring_kernel", "Merged")
