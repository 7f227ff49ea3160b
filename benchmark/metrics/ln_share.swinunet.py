"""The LayerNorms' share of the device's busy time in training (Swin-Unet's
38 float32 LayerNorms, ``models/swin_unet.py``): device time of every
operation launched under a layer-norm host operation, forward (with
autocast's casts of its input) and backward, over the busy union.  None
where nothing ran under one."""

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
HOST_OPS = frozenset({
    "aten::layer_norm", "aten::native_layer_norm", "aten::native_layer_norm_backward",
})


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    spent = ctx.trace.seconds_under(HOST_OPS)
    if spent <= 0:
        return None
    return 100.0 * spent / ctx.trace.busy_s
