"""The served forward's share of the card's dense bf16 peak: the forward
FLOPs of the requested images (padding not counted) over the device's
span in the trace (first operation's start to last one's end) and the
peak."""

from benchmark.yardstick import forward_flops

UNIT = "%"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def read(ctx):
    w = ctx.work
    if ctx.trace is None or not ctx.trace.ops or ctx.peak is None or not w.get("images"):
        return None
    flops = forward_flops(w["images"], w["size"], w["base"])
    return 100.0 * flops / ctx.trace.span_s / ctx.peak["flops"]
