"""TransUNet's convolutions (``models/transunet.py``: the ResNet's
weight-standardised ones, the token embedding, the decoder's and the
head; cuDNN under bf16 autocast) against their roofline: the least time
the card could take for the window's convolutions
(``yardstick_transunet.conv_bound_seconds``: per convolution, operations
or bytes, whichever is larger; three passes a training step, two of the
root, one a validation batch) over the device time of every operation
launched under a convolution's host operation, forward and backward:
cuDNN's kernels, its NCHW/NHWC layout transposes and autocast's casts of
the operands.  None where the window has no training step."""

from benchmark.yardstick_transunet import conv_bound_seconds

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"
HOST_OPS = frozenset({
    "aten::conv2d", "aten::convolution", "aten::_convolution", "aten::cudnn_convolution",
    "aten::convolution_backward",
})


def read(ctx):
    w = ctx.work
    if ctx.trace is None or ctx.peak is None or not w.get("train_steps") or "model" not in w:
        return None
    spent = ctx.trace.seconds_under(HOST_OPS)
    if spent <= 0:
        return None
    bound = conv_bound_seconds(w["model"], w["size"], w["batch"], ctx.peak, w["train_steps"],
                               w["val_batches"])
    return 100.0 * bound / spent
