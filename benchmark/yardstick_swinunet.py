"""The yardstick of the Swin-Unet cells: operations and bytes counted from
the configuration's shapes, frozen so that a change to the program cannot
move the ruler it is measured with.

A multiply-add counts 2 operations, a bf16 value 2 bytes.  Counted: the
patch embedding's and the head's convolutions, every linear (each block's
qkv, proj, fc1, fc2; patch merging's reduction; each patch expansion's and
the x4 expansion's expand; ``concat_back_dim``) and the window attention's
two products (``q k^T`` and ``p v``: 4 L N C a block of L tokens, width C,
N tokens a window).  Not counted: norms, activations, softmax, rolls and
partitions, concatenations, stochastic depth.  A training step is 3
forwards (the forward, the input gradient, the weight gradient; for the
attention, 4 L N C forward and 8 L N C backward).  At 896^2 and the
published widths a forward of one image is 194.3 GFLOP: linears and
convolutions 187.4 G, attention 6.8 G; a training step of 8 images 4.66
TFLOP.
"""

from __future__ import annotations

__all__ = ["attention_calls", "window_counts", "linear_flops", "attention_flops",
           "forward_flops", "step_flops", "attention_pairs", "attention_bound_seconds"]

BF16_BYTES = 2


def _stages(model: dict, s: int) -> list[tuple[int, int, int, int, int]]:
    """``(tokens a side, width, heads, window, depth)`` of each encoder stage."""
    side = s // model["patch_size"]
    out = []
    for i, depth in enumerate(model["depths"]):
        r = side // 2 ** i
        out.append((r, model["embed_dim"] * 2 ** i, model["num_heads"][i],
                    min(model["window_size"], r), depth))
    return out


def attention_calls(model: dict, s: int) -> list[tuple[int, int, int, int]]:
    """``(tokens L, width C, heads, window w)`` of every window-attention
    call of one forward on ``s`` x ``s`` images, in order: the encoder's
    blocks, then those of the decoder's stages 1-3 (the encoder's stages
    2, 1, 0 mirrored)."""
    st = _stages(model, s)
    order = list(range(len(st))) + list(range(len(st) - 2, -1, -1))
    return [(st[i][0] ** 2, st[i][1], st[i][2], st[i][3]) for i in order
            for _ in range(st[i][4])]


def window_counts(model: dict, s: int) -> dict:
    """The ``windows`` one image's forward attends, and its calls on a
    ``shifted`` map: each stage's odd blocks, where the stage is wider than
    a window (a stage of one window is not shifted)."""
    st = _stages(model, s)
    order = list(range(len(st))) + list(range(len(st) - 2, -1, -1))
    return {"windows": sum(length // (w * w) for length, _, _, w in attention_calls(model, s)),
            "shifted": sum(st[i][4] // 2 for i in order if st[i][0] > st[i][3])}


def linear_flops(model: dict, s: int) -> float:
    """The convolutions' and linears' operations in one image's forward."""
    st = _stages(model, s)
    e, mlp = model["embed_dim"], model["mlp_ratio"]
    tokens0 = st[0][0] ** 2
    total = 2.0 * tokens0 * 3 * model["patch_size"] ** 2 * e  # patch embedding
    for length, c, _, _ in attention_calls(model, s):
        total += 2.0 * length * c * c * (3 + 1 + 2 * mlp)  # qkv, proj, fc1, fc2
    for r, c, _, _, _ in st[:-1]:
        total += 2.0 * (r * r // 4) * 4 * c * 2 * c  # patch merging's reduction
    for r, c, _, _, _ in st[1:]:
        total += 2.0 * r * r * c * 2 * c  # a patch expansion of this stage's map
        total += 2.0 * (4 * r * r) * c * (c // 2)  # concat_back_dim of the stage above
    total += 2.0 * tokens0 * e * 16 * e  # x4 expansion
    total += 2.0 * s * s * e * model["n_classes"]  # head
    return total


def attention_flops(model: dict, s: int) -> float:
    """The window attention's two products in one image's forward: 4 L N C
    a call."""
    return sum(4.0 * length * w * w * c for length, c, _, w in attention_calls(model, s))


def attention_pairs(model: dict, s: int) -> int:
    """The query-key pairs of one image's forward: windows x heads x N^2
    summed over the calls, as the program's ``attention_counts`` counts them."""
    return sum(length * h * w * w for length, _, h, w in attention_calls(model, s))


def forward_flops(model: dict, s: int, b: int = 1) -> float:
    return b * (linear_flops(model, s) + attention_flops(model, s))


def step_flops(model: dict, s: int, b: int) -> float:
    """A training step's operations: 3 forwards."""
    return 3.0 * forward_flops(model, s, b)


def _call_seconds(length: int, c: int, h: int, w: int, b: int, peak: dict) -> tuple:
    """(forward, backward) floor of one call over ``b`` images: the larger of
    the operations over the bf16 peak and the bytes over the bandwidth.
    Bytes forward: q, k, v read and o written, and the (windows, heads, N,
    N) bias read once; backward: q, k, v, o and dO read, dq, dk, dv and the
    bias's gradient written."""
    n = w * w
    act = BF16_BYTES * b * length * c
    bias = BF16_BYTES * (length // n) * h * n * n
    ops = 4.0 * b * length * n * c
    fwd = max(ops / peak["flops"], (4 * act + bias) / peak["bytes"])
    bwd = max(2 * ops / peak["flops"], (8 * act + bias) / peak["bytes"])
    return fwd, bwd


def attention_bound_seconds(model: dict, s: int, b: int, peak: dict, train_steps: int,
                            val_batches: int) -> float:
    """The least time the card could take for a window's attention: per
    training step each call's forward and backward floor, per validation
    batch its forward floor."""
    total = 0.0
    for call in attention_calls(model, s):
        fwd, bwd = _call_seconds(*call, b, peak)
        total += train_steps * (fwd + bwd) + val_batches * fwd
    return total
