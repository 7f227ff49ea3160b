"""Share of the traced serving window in which the device is idle while
the host is in the Predictor's input path (``serve.py``: a chunk's slice,
padding and copy to the card, span ``piis.upload``; ``benchmark/spans.py``
charges each idle instant to the innermost span open on the host).  None
where the program opened no span."""

from benchmark.spans import spans_of

UNIT = "%"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def read(ctx):
    sp = spans_of(ctx.trace)
    if sp is None:
        return None
    return 100.0 * sp.idle(("piis.upload",)) / ctx.trace.window_s
