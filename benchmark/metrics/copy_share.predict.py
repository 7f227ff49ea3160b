"""The Predictor's copies between host and card as a share of the traced
serving window (``serve.py``: pageable copies each way): device time of
the ``Memcpy`` operations charged to spans ``piis.upload`` and
``piis.fetch`` (``benchmark/spans.py``) over the window.  None where the
program opened no span."""

from benchmark.spans import spans_of

UNIT = "%"
SOURCE = "device_trace"
MOVES = "predict_img_per_s"


def read(ctx):
    sp = spans_of(ctx.trace)
    if sp is None:
        return None
    copies = sp.device(("piis.upload", "piis.fetch"), op=lambda n: n.startswith("Memcpy"))
    return 100.0 * copies / ctx.trace.window_s
