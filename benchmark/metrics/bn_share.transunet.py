"""The BatchNorms' share of the device's busy time in training (the
TransUNet decoder's ``conv_more`` and blocks, ``models/transunet.py``):
device time of every operation launched under a batch-norm host operation,
forward (statistics, normalisation, the running statistics' update) and
backward, over the busy union.  None where nothing ran under one, as in a
model without BatchNorm."""

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
HOST_OPS = frozenset({
    "aten::batch_norm", "aten::_batch_norm_impl_index", "aten::native_batch_norm",
    "aten::cudnn_batch_norm", "aten::_native_batch_norm_legit",
    "aten::_batch_norm_with_update", "aten::_batch_norm_no_update",
    "aten::native_batch_norm_backward", "aten::cudnn_batch_norm_backward",
    "aten::batch_norm_backward",
})


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    spent = ctx.trace.seconds_under(HOST_OPS)
    if spent <= 0:
        return None
    return 100.0 * spent / ctx.trace.busy_s
