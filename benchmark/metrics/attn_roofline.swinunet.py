"""Swin-Unet's window attention (``models/swin_unet.py``: one
``F.scaled_dot_product_attention`` with the relative-position bias and the
shift mask a block, fused backends only) against its roofline: the least
time the card could take for the window's attention
(``yardstick_swinunet.attention_bound_seconds``: per call, the larger of
its operations over the bf16 peak and its bytes over the bandwidth,
forward and backward for each training step, forward for each validation
batch) over the device time charged to span ``piis.attention`` (forward,
and backward by ``sequence_nr``; ``benchmark/spans.py``).  None where the
program opened no such span, or where its ``attention_counts`` disagree
with the yardstick's calls and query-key pairs (the count would then
measure another model)."""

from benchmark.spans import spans_of
from benchmark.yardstick_swinunet import attention_bound_seconds, attention_calls, attention_pairs

UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_img_per_s"


def read(ctx):
    w = ctx.work
    sp = spans_of(ctx.trace)
    if sp is None or ctx.peak is None or "model" not in w or "attention_counts" not in w:
        return None
    counts, model, s, b = w["attention_counts"], w["model"], w["size"], w["batch"]
    if (counts["calls"] != counts["forwards"] * len(attention_calls(model, s))
            or counts["pairs"] != counts["forwards"] * b * attention_pairs(model, s)):
        return None
    spent = sp.device(("piis.attention",))
    if spent <= 0:
        return None
    bound = attention_bound_seconds(model, s, b, ctx.peak, w["train_steps"], w["val_batches"])
    return 100.0 * bound / spent
