"""``metrics/ln_roofline.swinunet.py``: the byte floor of Swin-Unet's 38
LayerNorms at the cell's configuration against a count by hand, the sites
at the widths, token counts and types the port's model runs them, and the
reading of a made-up trace: the floor over the device time of the norm
kernels alone, and nothing where no such kernel ran or there is no trace."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as R
from benchmark.yardstick import PEAKS

from .test_bench_spans import US, Ev, _launcher, _trace
from .tiny import REPO

CELL = "train-swinunet-896-b8"
CONF = json.loads((REPO / "benchmark/configs/swinunet-tiny-896.json").read_text())
PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def _reader():
    return R.reader_of(R.load_cell(CELL), "ln_roofline.swinunet")


# (count, width, token side, input bytes, output bytes) of the published
# Swin-T's norms at 896² (token sides 224, 112, 56, 28): the patch
# embedding, 8 encoder blocks' two norms, 3 mergings, the final norm, the
# first expand, 6 decoder blocks' two norms, 2 expands, norm_up, the x4
HAND = [(1, 96, 224, 2, 4),
        (4, 96, 224, 4, 2), (4, 192, 112, 4, 2), (4, 384, 56, 4, 2), (4, 768, 28, 4, 2),
        (1, 384, 112, 4, 2), (1, 768, 56, 4, 2), (1, 1536, 28, 4, 2),
        (1, 768, 28, 4, 2),
        (1, 384, 56, 2, 4),
        (4, 384, 56, 4, 2), (4, 192, 112, 4, 2), (4, 96, 224, 4, 2),
        (1, 192, 112, 2, 4), (1, 96, 224, 2, 4),
        (1, 96, 224, 4, 2),
        (1, 96, 896, 2, 2)]


def test_floor_counts_the_38_norms():
    reader, model = _reader(), CONF["model"]
    assert sum(k for k, *_ in HAND) == 38
    got = sorted(reader.norm_sites(model, 896))
    want = sorted((c, side * side, xb, yb) for k, c, side, xb, yb in HAND for _ in range(k))
    assert got == want
    b, steps, val = 8, 24, 6
    fwd = sum(k * b * c * side * side * (xb + yb) for k, c, side, xb, yb in HAND)
    bwd = sum(k * b * c * side * side * (2 * xb + yb) for k, c, side, xb, yb in HAND)
    assert reader.floor_bytes(model, 896, b, steps, val) == (steps + val) * fwd + steps * bwd
    # 7.12 GB a forward, 11.24 GB a training step's backward
    assert fwd == pytest.approx(7.119e9, rel=1e-3) and bwd == pytest.approx(11.243e9, rel=1e-3)


def test_sites_follow_the_model():
    """The port's Swin-Unet calls its norms at the reader's widths and
    token counts, in the reader's order, and under bf16 autocast in the
    reader's input and output types (224², embed 24)."""
    from physics_informed_image_segmentation_tpu_torch.models import SwinUnet
    from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

    small = dict(CONF["model"], embed_dim=24, num_heads=[1, 2, 4, 8])
    model = SwinUnet(img_size=224, embed_dim=24, num_heads=(1, 2, 4, 8)).eval()
    calls, real = [], LN.LayerNormFn.apply

    def record(x, weight, bias, eps, out_dtype):
        calls.append((x.shape[-1], x.numel() // x.shape[-1], x.element_size(),
                      torch.empty((), dtype=out_dtype).element_size()))
        return real(x, weight, bias, eps, out_dtype)

    LN.LayerNormFn.apply = record
    try:
        with torch.no_grad(), torch.autocast("cpu", torch.bfloat16):
            model(torch.rand(1, 1, 224, 224))
    finally:
        LN.LayerNormFn.apply = real
    assert calls == _reader().norm_sites(small, 224)


def _step():
    """A made-up step: the norm kernels each way, a matrix product and
    PyTorch's own LayerNorm kernel beside them."""
    fwd = Ev("piis.transformer", 0, 100, Ev("piis.forward", 0, 500))
    ln = _launcher("LayerNormFnBackward", 30, 40, fwd, "cudaLaunchKernel", 32)
    mm = _launcher("aten::mm", 10, 20, fwd, "cudaLaunchKernel", 12)
    return [(14, 34, "sm90_xmma_gemm_bf16bf16_bf16f32", mm),
            (34, 44, "void (anonymous namespace)::layer_norm_fwd<float, __nv_bfloat16, 96>"
                     "(float const*, float const*, float const*, __nv_bfloat16*, float*, float*, "
                     "long long, float)", ln),
            (44, 74, "void (anonymous namespace)::layer_norm_bwd<__nv_bfloat16, __nv_bfloat16, "
                     "96>(__nv_bfloat16 const*)", ln),
            (74, 78, "void (anonymous namespace)::layer_norm_bwd_params(float const*, int, int, "
                     "float*, float*)", ln),
            (78, 99, "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, "
                     "float, false>(int, float, float const*)", ln)]


def test_reads_the_floor_over_the_norm_kernels():
    reader, model = _reader(), CONF["model"]
    work = {"train_steps": 1, "val_batches": 1, "batch": 8, "size": 896, "model": model}
    ctx = SimpleNamespace(trace=_trace(_step(), 1000 * US), work=work, peak=PEAK)
    floor = reader.floor_bytes(model, 896, 8, 1, 1)
    assert reader.read(ctx) == pytest.approx(100 * floor / PEAK["bytes"] / (44 * US))


def test_reads_nothing_without_the_kernels():
    """PyTorch's LayerNorm (the parent's path), no trace, no peak or
    another model's work: no reading, and nothing raised."""
    reader = _reader()
    work = {"train_steps": 1, "val_batches": 1, "batch": 8, "size": 896, "model": CONF["model"]}
    plain = [op for op in _step() if "layer_norm_fwd" not in op[2]
             and "layer_norm_bwd" not in op[2]]
    transunet = json.loads((REPO / "benchmark/configs/transunet-r50b16-1024.json").read_text())
    for trace, w, peak in ((_trace(plain, 1000 * US), work, PEAK), (None, work, PEAK),
                           (_trace(_step(), 1000 * US), work, None),
                           (_trace(_step(), 1000 * US), dict(work, model=transunet["model"]),
                            PEAK),
                           (_trace(_step(), 1000 * US), {"batch": 8, "size": 896}, PEAK)):
        assert reader.read(SimpleNamespace(trace=trace, work=w, peak=peak)) is None
