"""The yardstick of the TransUNet cells: operations counted from the
configuration's shapes, frozen so that a change to the program cannot move
the ruler it is measured with.

A multiply-add counts 2 operations, a bf16 value 2 bytes.  Counted: every convolution
(ResNet, token embedding, decoder, head), every matrix product of the
transformer (q, k, v, out, fc1, fc2) and the attention's two products
(``q k^T`` and ``p v``: 4 N^2 d a layer, d the hidden width).  Not
counted: norms, activations, softmax, pooling, upsampling, dropout.  A
training step is 3 forwards (the forward, the input gradient, the weight
gradient; for the attention, 4 N^2 d forward and 8 N^2 d backward).  At
1024^2 a forward of one image is 1.809 TFLOP: convolutions 494.6 G, matrix
products 695.8 G, attention 618.5 G.
"""

from __future__ import annotations

__all__ = ["conv_layers", "conv_flops", "matmul_flops", "attention_flops", "forward_flops",
           "step_flops", "attention_bound_seconds", "conv_bound_seconds"]

HEAD_CHANNELS = 512  # conv_more's width, a constant of the published decoder
BF16_BYTES = 2


def conv_layers(model: dict, s: int) -> list[tuple[int, int, int, int, int]]:
    """``(cin, cout, output side, taps, input side)`` of every convolution
    of the TransUNet described by ``model`` (the configuration's model
    group) on ``s`` x ``s`` images, the root first."""
    w = model["width"]
    side = s // 2
    convs = [(3, w, side, 49, s)]  # root, 7x7 stride 2
    side = (side - 3) // 2 + 1  # max pool 3x3 stride 2, no padding
    cin = w
    for i, units in enumerate(model["block_units"]):
        cout, cmid, stride = 4 * w * 2 ** i, w * 2 ** i, 1 if i == 0 else 2
        for u in range(units):
            out = (side - 1) // stride + 1 if u == 0 else side  # 3x3 pad 1, or 1x1
            convs.append((cin if u == 0 else cout, cmid, side, 1, side))
            convs.append((cmid, cmid, out, 9, side))
            convs.append((cmid, cout, out, 1, out))
            if u == 0 and (stride != 1 or cin != cout):
                convs.append((cin, cout, out, 1, side))
            side = out
        cin = cout
    grid = s // 16
    hidden = model["hidden_size"]
    convs.append((cin, hidden, grid, 1, grid))  # token embedding
    convs.append((hidden, HEAD_CHANNELS, grid, 9, grid))  # conv_more
    skips = (8 * w, 4 * w, w, 0)
    c, side = HEAD_CHANNELS, grid
    for out_c, skip in zip(model["decoder_channels"], skips):
        side *= 2
        convs += [(c + skip, out_c, side, 9, side), (out_c, out_c, side, 9, side)]
        c = out_c
    convs.append((c, model["n_classes"], s, 9, s))  # head
    return convs


def conv_flops(model: dict, s: int) -> float:
    """The convolutions' operations in one image's forward."""
    return sum(2.0 * side * side * cin * cout * taps
               for cin, cout, side, taps, _ in conv_layers(model, s))


def matmul_flops(model: dict, s: int) -> float:
    """The transformer's matrix products (q, k, v, out, fc1, fc2) in one
    image's forward."""
    n, d, mlp = (s // 16) ** 2, model["hidden_size"], model["mlp_dim"]
    return model["num_layers"] * (2.0 * n * d * d * 4 + 2.0 * n * d * mlp * 2)


def attention_flops(model: dict, s: int) -> float:
    """The attention's two products (q k^T, p v) in one image's forward:
    4 N^2 d a layer."""
    n = (s // 16) ** 2
    return model["num_layers"] * 4.0 * n * n * model["hidden_size"]


def forward_flops(model: dict, s: int, b: int = 1) -> float:
    return b * (conv_flops(model, s) + matmul_flops(model, s) + attention_flops(model, s))


def step_flops(model: dict, s: int, b: int) -> float:
    """A training step's operations: 3 forwards."""
    return 3.0 * forward_flops(model, s, b)


def attention_bound_seconds(model: dict, s: int, b: int, peak: dict, train_steps: int,
                            val_batches: int) -> float:
    """The least time the card could take for a window's attention at its
    bf16 peak: per training step its forward and backward (3 x forward's
    4 N^2 d a layer), per validation batch its forward."""
    one = b * attention_flops(model, s)
    return (3 * train_steps + val_batches) * one / peak["flops"]


def conv_bound_seconds(model: dict, s: int, b: int, peak: dict, train_steps: int,
                       val_batches: int) -> float:
    """The least time the card could take for a window's convolutions: per
    convolution and pass over ``b`` images, the larger of its operations
    over the bf16 peak and its bytes (input, weights and output in bf16,
    each once) over the bandwidth.  A training step makes 3 passes of each
    (forward, input gradient, weight gradient) but 2 of the root, whose
    input, the image, needs no gradient; a validation batch makes 1."""
    total = 0.0
    for i, (cin, cout, side, taps, in_side) in enumerate(conv_layers(model, s)):
        flops = 2.0 * b * side * side * cin * cout * taps
        nbytes = BF16_BYTES * (b * in_side * in_side * cin + b * side * side * cout
                               + cin * cout * taps)
        one = max(flops / peak["flops"], nbytes / peak["bytes"])
        total += ((2 if i == 0 else 3) * train_steps + val_batches) * one
    return total
