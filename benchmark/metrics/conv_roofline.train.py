"""The U-Net's convolutions (``models/unet.py``, cuDNN under bf16
autocast) against their roofline: the least time the card could take for
the window's convolutions (``yardstick.conv_bound_seconds``: three
forward-sized passes a training step, one a validation batch) over the
device time of every operation launched under a convolution's host
operation, forward and backward: cuDNN's kernels, its NCHW/NHWC layout
transposes and autocast's casts of the operands."""

from benchmark.yardstick import conv_bound_seconds

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
HOST_OPS = frozenset({
    "aten::conv2d", "aten::conv_transpose2d", "aten::convolution", "aten::_convolution",
    "aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
    "aten::convolution_backward",
})


def read(ctx):
    w = ctx.work
    if ctx.trace is None or ctx.peak is None or not w.get("train_steps"):
        return None
    spent = ctx.trace.seconds_under(HOST_OPS)
    if spent <= 0:
        return None
    bound = (w["train_steps"] * conv_bound_seconds(w["batch"], w["size"], w["base"], ctx.peak, 3)
             + w["val_batches"] * conv_bound_seconds(w["batch"], w["size"], w["base"], ctx.peak, 1))
    return 100.0 * bound / spent
