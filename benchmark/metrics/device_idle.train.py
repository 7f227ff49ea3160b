"""Share of the traced training window in which no operation ran on the
device: 1 - (union of the device operations' intervals) / window.  The
host's dispatch of each step (``train/engine.py``) is what leaves it idle."""

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
