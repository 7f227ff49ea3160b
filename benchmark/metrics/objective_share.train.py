"""The Stage II objective's share of the device's busy time in training
(``train/objective.py``: BCE, Dice, the PDE and phase-field terms through
K1): device time charged to span ``piis.objective`` (training and
validation, forward and backward; ``benchmark/spans.py``) over the busy
union.  None where the program opened no span."""

from benchmark.spans import spans_of

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    sp = spans_of(ctx.trace)
    if sp is None:
        return None
    return 100.0 * sp.device(("piis.objective",)) / ctx.trace.busy_s
