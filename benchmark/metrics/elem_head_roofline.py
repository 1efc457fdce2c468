"""``elem_head``'s share of its roofline over the traced window: the least
time of the work the window's frames need over the summed device time of
its kernels.

The work is counted here from the benchmark's own inputs (``Frames``:
each frame's live samples, channels and each channel's predictor order,
as the frozen encoder wrote them), never from the kernel's arguments.  A
frame of C channels has the elements of its map (``inputs/surround``);
each element after the first is one pass of the kernel over the frame's
lane, and one more pass reads the END tag.  A pass of an element reads
its header once (23 bits, 16 of shift and weight, 16 a channel and 16 a
coefficient; the 32-bit count of a partial frame left out), 72 B of lane
columns (element 0's cookie columns, the previous element's, its end
bits and the status) and writes 90 int32 rows and 2 flag bytes; the END
pass reads the 72 B and writes the sample count.  Operations: about 12
int32 operations a field read (two word loads, a funnel shift, a mask,
the position) and 100 a pass (the map, the counts, the row writes).
"""

import numpy as np

from benchmark import yardstick
from benchmark.inputs.surround import CHANNEL_ELEMENTS

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "decode_msamples_per_s"

LANE_IN, ROWS_OUT, END_OUT = 72, 90 * 4 + 2, 4
OPS_FIELD, OPS_PASS = 12, 100


def elem_head_work(f) -> tuple[int, int]:
    kinds = CHANNEL_ELEMENTS.get(f.channels)
    if kinds is None:
        return 0, 0
    frames = int(f.n.size)
    first = np.cumsum((0,) + kinds)[:-1]
    orders = np.where(f.orders == 31, 31, f.orders)
    head_bits = 0
    fields = 0
    for e in range(1, len(kinds)):
        o = orders[:, first[e]:first[e] + kinds[e]]
        head_bits += int((23 + 16 + (16 + 16 * o).sum(axis=1)).sum())
        fields += int((6 + 4 * kinds[e] + o.sum(axis=1)).sum())
    passes = len(kinds) - 1
    nbytes = head_bits // 8 + frames * (passes * (LANE_IN + ROWS_OUT) + LANE_IN + END_OUT)
    ops = OPS_FIELD * fields + OPS_PASS * frames * (passes + 1)
    return nbytes, ops


def read(w):
    return yardstick.roofline_pct(w, elem_head_work, "elem_head_kernel")
