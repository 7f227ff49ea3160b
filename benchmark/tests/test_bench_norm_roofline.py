"""``metrics/norm_roofline.transunet.py``: the byte floor of the ResNet's
52 norms at 224² and 1024² against a count by hand, the sites in the
order and at the shapes the port's model calls them, and the reading of a
made-up trace: the floor over the device time of the norm kernels alone,
and nothing where no such kernel ran."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as R
from benchmark.yardstick import PEAKS

from .test_bench_spans import US, Ev, _launcher, _trace
from .tiny import REPO

CELL = "train-transunet-1024-b8"
CONF = json.loads((REPO / "benchmark/configs/transunet-r50b16-1024.json").read_text())
PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def _reader():
    return R.reader_of(R.load_cell(CELL), "norm_roofline.transunet")


def _by_hand(root: int, b1: int, b2: int, b3: int) -> list[tuple[int, int, int, bool]]:
    """(count, channels, side, gn_proj) of the published ResNet's norms:
    the root's side, then each block's side (block 2's and 3's first gn1
    runs at the side before their stride)."""
    return [(1, 64, root, False),
            (1, 256, b1, True), (3, 64, b1, False), (3, 64, b1, False), (3, 256, b1, False),
            (1, 512, b2, True), (1, 128, b1, False), (3, 128, b2, False), (4, 128, b2, False),
            (4, 512, b2, False),
            (1, 1024, b3, True), (1, 256, b2, False), (8, 256, b3, False), (9, 256, b3, False),
            (9, 1024, b3, False)]


@pytest.mark.parametrize("size, sides", [(1024, (512, 255, 128, 64)), (224, (112, 55, 28, 14))])
def test_floor_counts_the_52_norms(size, sides):
    reader, model = _reader(), CONF["model"]
    table = _by_hand(*sides)
    assert sum(k for k, *_ in table) == 52
    got = sorted(reader.norm_sites(model, size))
    want = sorted(site for k, *site in table for _ in range(k))
    assert got == [tuple(s) for s in want]
    b, steps, val = 8, 3, 2
    fwd = sum(k * b * c * s * s * (2 if proj else 4) for k, c, s, proj in table)
    bwd = sum(k * b * c * s * s * (4 if proj else 6) for k, c, s, proj in table)
    assert reader.floor_bytes(model, size, b, steps, val) == (steps + val) * fwd + steps * bwd
    if size == 1024:  # 237 M normalised elements an image
        assert sum(k * c * s * s for k, c, s, _ in table) == pytest.approx(237.1e6, rel=1e-3)


def test_sites_follow_the_model():
    """The port's TransUNet calls its norms at the reader's channels and
    sides, in the reader's order (published block units, small widths)."""
    from physics_informed_image_segmentation_tpu_torch.models import TransUNet
    from physics_informed_image_segmentation_tpu_torch.models import transunet as T

    small = dict(CONF["model"], width=32, hidden_size=32, num_layers=1, num_heads=2, mlp_dim=32,
                 decoder_channels=[16, 8, 8, 4])
    model = TransUNet(img_size=64, width=32, hidden_size=32, num_layers=1, num_heads=2,
                      mlp_dim=32, decoder_channels=(16, 8, 8, 4)).eval()
    calls, real = [], T.group_norm_act

    def record(x, norm, counts, **kw):
        calls.append((x.shape[1], x.shape[2], not kw.get("relu", True) and "residual" not in kw))
        return real(x, norm, counts, **kw)

    T.group_norm_act = record
    try:
        with torch.no_grad():
            model(torch.rand(1, 1, 64, 64))
    finally:
        T.group_norm_act = real
    assert calls == _reader().norm_sites(small, 64)
    assert model.norm_counts == {"fused": 0, "plain": 52}


def _step():
    """A made-up step: one forward and one backward kernel of the norms,
    a convolution and an elementwise kernel beside them."""
    resnet = Ev("piis.resnet", 0, 100, Ev("piis.forward", 0, 500))
    gn = _launcher("GroupNormActBackward", 30, 40, resnet, "cudaLaunchKernel", 32)
    conv = _launcher("aten::conv2d", 10, 20, resnet, "cudaLaunchKernel", 12)
    return [(14, 34, "sm90_xmma_fprop", conv),
            (34, 44, "void (anonymous namespace)::group_norm_fwd_stats<__nv_bfloat16>"
                     "(__nv_bfloat16 const*, double2*, long long, int)", gn),
            (44, 64, "void (anonymous namespace)::group_norm_fwd_apply<__nv_bfloat16, float, "
                     "true, true>(__nv_bfloat16 const*, float const*)", gn),
            (64, 94, "void (anonymous namespace)::group_norm_bwd_apply<float, float, false, "
                     "true>(float const*)", gn),
            (94, 99, "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>"
                     "(long, float, float const*, float*, float*)", gn)]


def test_reads_the_floor_over_the_norm_kernels():
    reader, model = _reader(), CONF["model"]
    work = {"train_steps": 1, "val_batches": 1, "batch": 8, "size": 1024, "model": model}
    ctx = SimpleNamespace(trace=_trace(_step(), 1000 * US), work=work, peak=PEAK)
    floor = reader.floor_bytes(model, 1024, 8, 1, 1)
    assert reader.read(ctx) == pytest.approx(100 * floor / PEAK["bytes"] / (60 * US))


def test_reads_nothing_without_the_kernels():
    """PyTorch's GroupNorm (the parent's path), no trace, no peak or the
    U-Net's work: no reading, and nothing raised."""
    reader = _reader()
    work = {"train_steps": 1, "val_batches": 1, "batch": 8, "size": 1024, "model": CONF["model"]}
    plain = [op for op in _step() if "group_norm_" not in op[2]]
    for trace, w, peak in ((_trace(plain, 1000 * US), work, PEAK), (None, work, PEAK),
                           (_trace(_step(), 1000 * US), work, None),
                           (_trace(_step(), 1000 * US), {"batch": 8, "size": 1024}, PEAK)):
        assert reader.read(SimpleNamespace(trace=trace, work=w, peak=peak)) is None
