"""Swin-Unet's token resampling's share of the device's busy time in
training (``models/swin_unet.py``: every ``PatchMerging``, ``PatchExpand``
and ``FinalPatchExpand_X4`` with its linear, rearrangement and LayerNorm;
training and validation, forward and backward): device time charged to
span ``piis.resample`` (``benchmark/spans.py``) over the busy union.  None
where the program opened no such span."""

from benchmark.spans import spans_of

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    sp = spans_of(ctx.trace)
    if sp is None:
        return None
    spent = sp.device(("piis.resample",))
    if spent <= 0:
        return None
    return 100.0 * spent / ctx.trace.busy_s
