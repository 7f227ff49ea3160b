"""The benchmark's yardstick: peaks, operation and byte counts, the busy union.

Frozen copies, so that a change to the program cannot move the ruler it is
measured with:

* ``analytic_flops_per_step`` is the port's ``bench.py`` count (the JAX
  bench's): the U-Net's convolutions, multiply-adds x2, x3 for a training
  step (forward, input gradient, weight gradient);
* ``PEAKS`` holds the data sheet's dense bf16 rate (the port's
  ``utils/measure.py::PEAK_FLOPS``) and the memory bandwidth;
* ``busy_union`` is ``utils/profile_step.py::_busy_us``, on plain intervals.
"""

from __future__ import annotations

# dense bf16 tensor-core rate (FLOP/s) and HBM bandwidth (bytes/s) by
# ``torch.cuda.get_device_name``; NVIDIA H100 data sheet, without sparsity,
# at the part's full power limit
PEAK_SOURCE = "NVIDIA H100 data sheet, dense bf16, full power limit"
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 989.4e12, "bytes": 3.35e12},  # SXM
    "NVIDIA H100 PCIe": {"flops": 756e12, "bytes": 2.0e12},
}

BF16_BYTES = 2
F32_BYTES = 4


def conv_layers(s: int, c: int) -> list[tuple[int, int, int, int, int]]:
    """``(cin, cout, output side, taps, input side)`` of every convolution
    of the U-Net at base width ``c`` on ``s`` x ``s`` images: 3x3
    convolutions have 9 taps; a 2x2 stride-2 transposed convolution gives
    each output pixel one tap and reads half the side; the output
    convolution is 1x1."""
    convs = []
    plan = [(1, c), (c, c)], [(c, 2 * c), (2 * c, 2 * c)], \
        [(2 * c, 4 * c), (4 * c, 4 * c)], [(4 * c, 8 * c), (8 * c, 8 * c)]
    sp = s
    for level in plan:
        for cin, cout in level:
            convs.append((cin, cout, sp, 9, sp))
        sp //= 2
    convs += [(8 * c, 8 * c, sp, 9, sp), (8 * c, 8 * c, sp, 9, sp)]  # bottleneck at s/16
    dec_plan = [
        (8 * c, 8 * c, s // 8), (16 * c, 8 * c, s // 8),   # up4, dec4 conv1
        (8 * c, 8 * c, s // 8),
        (8 * c, 4 * c, s // 4), (8 * c, 4 * c, s // 4), (4 * c, 4 * c, s // 4),
        (4 * c, 2 * c, s // 2), (4 * c, 2 * c, s // 2), (2 * c, 2 * c, s // 2),
        (2 * c, c, s), (2 * c, c, s), (c, c, s),
    ]
    taps = [1, 9, 9] * 4
    for (cin, cout, spx), k in zip(dec_plan, taps):
        convs.append((cin, cout, spx, k, spx // 2 if k == 1 else spx))
    convs.append((c, 1, s, 1, s))  # 1x1 output conv
    return convs


def forward_flops(b: int, s: int, c: int) -> float:
    """FLOPs of the U-Net's convolutions in one forward of ``b`` images."""
    return sum(2.0 * b * spx * spx * cin * cout * k for cin, cout, spx, k, _ in conv_layers(s, c))


def analytic_flops_per_step(b: int = 8, s: int = 128, c: int = 64) -> float:
    """Training-step FLOPs of the U-Net: the forward's, x3 (forward, input
    gradient, weight gradient, each about as costly)."""
    return 3.0 * forward_flops(b, s, c)


def conv_bound_seconds(b: int, s: int, c: int, peak: dict, passes: int) -> float:
    """Least time the card could take for the convolutions of ``passes``
    forward-sized passes over ``b`` images (1: a forward; 3: a training
    step): per convolution and pass, the larger of its operations over the
    bf16 peak and its bytes (input, weights and output in bf16, each once)
    over the bandwidth."""
    total = 0.0
    for cin, cout, spx, k, insp in conv_layers(s, c):
        flops = 2.0 * b * spx * spx * cin * cout * k
        nbytes = BF16_BYTES * (b * insp * insp * cin + b * spx * spx * cout + cin * cout * k)
        total += max(flops / peak["flops"], nbytes / peak["bytes"])
    return passes * total


def k1_bytes(b: int, h: int, w: int, backward: bool) -> int:
    """Bytes K1 must move, each input read once and each output written once.
    Forward: u, t (B, H, W), the mask (B, 1) in, the sums (B, 6) out.
    Backward (no target gradient, the training path): u, t, the mask and the
    cotangent (B, 6) in, du (B, H, W) out."""
    field = b * h * w
    if backward:
        return F32_BYTES * (3 * field + b + 6 * b)
    return F32_BYTES * (2 * field + b + 6 * b)


def busy_union(spans) -> tuple[float, float]:
    """(union of the intervals, first start to last end) of ``(start, end)``
    pairs, in their unit."""
    spans = sorted(spans)
    if not spans:
        return 0.0, 0.0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in spans) - spans[0][0]


def idle_gaps(spans) -> list[tuple[float, float]]:
    """The gaps ``(start, end)`` between the merged intervals of ``spans``."""
    spans = sorted(spans)
    gaps = []
    if not spans:
        return gaps
    cur_e = spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            gaps.append((cur_e, s))
        cur_e = max(cur_e, e)
    return gaps
