"""The whole Swin-Unet training step's share of the card's dense bf16 peak:
the analytic FLOPs of the window's training steps
(``yardstick_swinunet.step_flops``: the linears, the patch embedding's and
the head's convolutions and the window attention from the configuration's
shapes, 3 forwards a step; validation's forwards not counted) over the
device's span in the trace (first operation's start to last one's end)
and the peak, as ``mfu.train``."""

from benchmark.yardstick_swinunet import step_flops

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    w = ctx.work
    if (ctx.trace is None or not ctx.trace.ops or ctx.peak is None or not w.get("train_steps")
            or "model" not in w):
        return None
    flops = w["train_steps"] * step_flops(w["model"], w["size"], w["batch"])
    return 100.0 * flops / ctx.trace.span_s / ctx.peak["flops"]
