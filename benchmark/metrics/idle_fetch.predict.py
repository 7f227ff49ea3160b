"""Share of the traced serving window in which the device is idle while
the host is in the Predictor's output path (``serve.py``: the gather and
the copy to the host, span ``piis.fetch``, and the threshold, span
``piis.threshold``; ``benchmark/spans.py``).  None where the program
opened no span."""

from benchmark.spans import spans_of

UNIT = "%"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def read(ctx):
    sp = spans_of(ctx.trace)
    if sp is None:
        return None
    return 100.0 * sp.idle(("piis.fetch", "piis.threshold")) / ctx.trace.window_s
