"""The whole training step's share of the card's dense bf16 peak: the
analytic FLOPs of the window's training steps (``yardstick.
analytic_flops_per_step``; validation's forwards not counted) over the
device's span in the trace (first operation's start to last one's end)
and the peak.  It bounds every kernel's gain."""

from benchmark.yardstick import analytic_flops_per_step

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    w = ctx.work
    if ctx.trace is None or not ctx.trace.ops or ctx.peak is None or not w.get("train_steps"):
        return None
    flops = w["train_steps"] * analytic_flops_per_step(w["batch"], w["size"], w["base"])
    return 100.0 * flops / ctx.trace.span_s / ctx.peak["flops"]
