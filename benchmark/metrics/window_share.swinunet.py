"""Swin-Unet's window bookkeeping's share of the device's busy time in
training (``models/swin_unet.py``: each block's cyclic roll, window
partition and assembly of the relative-position bias and shift mask, and
its window reverse and roll back; training and validation, forward and
backward): device time charged to span ``piis.window``
(``benchmark/spans.py``) over the busy union.  None where the program
opened no such span, or where its ``window_counts`` disagree with the
yardstick's windows and shifted calls (the share would then be another
model's)."""

from benchmark.spans import spans_of
from benchmark.yardstick_swinunet import window_counts

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    w = ctx.work
    sp = spans_of(ctx.trace)
    if sp is None or any(k not in w for k in ("model", "attention_counts", "window_counts")):
        return None
    forwards, per = w["attention_counts"]["forwards"], window_counts(w["model"], w["size"])
    if w["window_counts"] != {"windows": forwards * w["batch"] * per["windows"],
                              "shifted": forwards * per["shifted"]}:
        return None
    spent = sp.device(("piis.window",))
    if spent <= 0:
        return None
    return 100.0 * spent / ctx.trace.busy_s
