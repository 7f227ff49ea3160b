"""TransUNet's attention (``models/transunet.py``: ``F.scaled_dot_product_attention``
limited to the fused backends) against its roofline: the least time the
card could take for the window's attention at the bf16 peak
(``yardstick_transunet.attention_bound_seconds``: 4 N^2 d a layer forward
and 8 N^2 d backward for each training step, the forward for each
validation batch) over the device time charged to span ``piis.attention``
(forward, and backward by ``sequence_nr``; ``benchmark/spans.py``).  None
where the program opened no such span."""

from benchmark.spans import spans_of
from benchmark.yardstick_transunet import attention_bound_seconds

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    w = ctx.work
    sp = spans_of(ctx.trace)
    if sp is None or ctx.peak is None or "model" not in w:
        return None
    spent = sp.device(("piis.attention",))
    if spent <= 0:
        return None
    bound = attention_bound_seconds(w["model"], w["size"], w["batch"], ctx.peak,
                                    w["train_steps"], w["val_batches"])
    return 100.0 * bound / spent
