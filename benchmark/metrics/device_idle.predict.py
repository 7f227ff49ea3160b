"""Share of the traced serving window in which no operation ran on the
device: 1 - (union of the device operations' intervals) / window.  The
Predictor's host path (``serve.py``: chunks, padding, copies) and the
client's own time between requests are what leave it idle."""

UNIT = "%"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
