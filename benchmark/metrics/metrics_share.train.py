"""Dice, IoU and Boundary-F1's share of the device's busy time in training
(``ops/metrics.py`` through ``train/engine.py``: every step's per-sample
metrics and validation's): device time charged to span ``piis.metrics``
(``benchmark/spans.py``) over the busy union.  None where the program
opened no span."""

from benchmark.spans import spans_of

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    sp = spans_of(ctx.trace)
    if sp is None:
        return None
    return 100.0 * sp.device(("piis.metrics",)) / ctx.trace.busy_s
