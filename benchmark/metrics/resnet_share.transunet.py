"""TransUNet's ResNetV2's share of the device's busy time in training
(``models/transunet.py``: the root and the three blocks of bottleneck
units, with their weight standardisation, GroupNorms, ReLUs, the max pool
and the skip's pad; training and validation, forward and backward):
device time charged to span ``piis.resnet`` (``benchmark/spans.py``) over
the busy union.  None where the program opened no such span."""

from benchmark.spans import spans_of

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    sp = spans_of(ctx.trace)
    if sp is None:
        return None
    spent = sp.device(("piis.resnet",))
    if spent <= 0:
        return None
    return 100.0 * spent / ctx.trace.busy_s
