"""The TransUNet cell on the CPU: a whole run of a tiny copy of
``train-transunet-1024-b8`` (64 x 64 images, small widths, float32, the
real cell's limits) is ``correct``, and a fault planted in the port makes
it incorrect; the window's work counts the attention; the yardstick's count
of a forward at the published widths is the one the configuration states,
and its convolutions' bound counts each pass; the cell's readers charge
each layer of a made-up trace, and read nothing where their layer is not."""

from __future__ import annotations

import json
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as R
from benchmark import yardstick_transunet as Y
from benchmark.yardstick import PEAKS

from .test_bench_faults import _half_batch, _unchanged
from .test_bench_spans import US, Ev, _launcher, _read, _trace
from .tiny import REPO

CELL = "train-transunet-1024-b8"
SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128, block_units=[1, 1, 1],
             width=32, decoder_channels=[32, 16, 8, 4], batch_size=2)
MIX = {"driver": "train_transunet", "why": "tiny", "train_images": 8, "val_images": 4,
       "first_steps": 3, "trace_epochs": 1}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _root(tmp):
    """The benchmark with a cell ``tiny-transunet``: the real cell's
    configuration at 64 x 64 and small widths in float32, its limits and
    metrics."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / "benchmark/configs/transunet-r50b16-1024.json").read_text())
    conf["model"].update(SMALL)
    conf["image_size"], conf["precision"] = 64, "f32"
    (tmp / "benchmark/configs/tiny-transunet.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny-transunet", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/tiny-transunet.json", "reduced": [],
                             "why": "tiny"})
    (tmp / "benchmark/traffic/tiny-transunet.json").write_text(json.dumps(MIX))
    shutil.copy(REPO / f"benchmark/limits/{CELL}.json",
                tmp / "benchmark/limits/tiny-transunet.json")
    bench["workloads"].append({"name": "tiny-transunet", "config": "tiny-transunet",
                               "traffic": "tiny-transunet", "chips": 1, "why": "tiny"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append("tiny-transunet")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch])
def test_a_fault_in_the_port_makes_the_transunet_run_incorrect(tmp_path, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    spec = R.load_cell("tiny-transunet", _root(tmp_path))
    result = R.run_cell(spec, 2 ** 31 + 77, 0.5, False, "cpu", time.perf_counter())
    assert result["correct"] is (fault is None), result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"] and "train_img_per_s" in result["metrics"]


def test_the_window_counts_the_attention(tmp_path):
    """The work a reader gets holds the model and the window's attention
    counts: every forward calls the attention once a layer."""
    spec = R.load_cell("tiny-transunet", _root(tmp_path))
    ctx = SimpleNamespace(cell=spec.name, config=spec.config, traffic=spec.traffic,
                          seed=2 ** 31 + 78, device=torch.device("cpu"))
    work = R.driver_of(spec).setup(ctx).window(0.0, trace=True)["work"]
    counts, tokens = work["attention_counts"], (64 // 16) ** 2
    assert counts["forwards"] == work["train_steps"] + work["val_batches"] == 4 + 2
    assert counts["calls"] == SMALL["num_layers"] * counts["forwards"]
    assert counts["pairs"] == counts["calls"] * 2 * SMALL["num_heads"] * tokens ** 2
    assert work["model"]["hidden_size"] == SMALL["hidden_size"]


def test_yardstick_counts_the_published_forward():
    conf = json.loads((REPO / "benchmark/configs/transunet-r50b16-1024.json").read_text())
    model, s = conf["model"], conf["image_size"]
    assert Y.conv_flops(model, s) == pytest.approx(494.6e9, rel=1e-3)
    assert Y.matmul_flops(model, s) == pytest.approx(695.8e9, rel=1e-3)
    assert Y.attention_flops(model, s) == pytest.approx(618.5e9, rel=1e-3)
    assert Y.forward_flops(model, s) == pytest.approx(1.809e12, rel=1e-3)
    assert Y.step_flops(model, s, 8) == 3 * 8 * Y.forward_flops(model, s)


def test_conv_bound_counts_every_convolution_once_a_pass():
    """Three passes a training step (two of the root, whose input needs no
    gradient), one a validation batch, each at least its operations over
    the peak; the decoder's full-resolution convolutions are bound by
    their bytes."""
    conf = json.loads((REPO / "benchmark/configs/transunet-r50b16-1024.json").read_text())
    model, s = conf["model"], conf["image_size"]
    peak = PEAKS["NVIDIA H100 80GB HBM3"]
    layers = Y.conv_layers(model, s)
    assert layers[0] == (3, 64, 512, 49, 1024) and layers[-1] == (16, 1, 1024, 9, 1024)
    root = 2.0 * 8 * 512 * 512 * 3 * 64 * 49 / peak["flops"]
    ops = 3 * 8 * Y.conv_flops(model, s) / peak["flops"] - root
    step = Y.conv_bound_seconds(model, s, 8, peak, 1, 0)
    assert ops <= step <= 1.5 * ops
    val = Y.conv_bound_seconds(model, s, 8, peak, 0, 1)
    assert 8 * Y.conv_flops(model, s) / peak["flops"] <= val < step / 2
    assert Y.conv_bound_seconds(model, s, 8, peak, 3, 2) == pytest.approx(3 * step + 2 * val)


def _transunet_step():
    """A made-up training step of the TransUNet: a forward in its four spans
    and its backward on autograd's thread, charged back by ``sequence_nr``."""
    step = Ev("piis.epoch", 0, 1000)
    fw = Ev("piis.forward", 0, 500, step)
    resnet, vit = Ev("piis.resnet", 0, 100, fw), Ev("piis.transformer", 100, 300, fw)
    attn, dec = Ev("piis.attention", 150, 200, vit), Ev("piis.decoder", 300, 500, fw)
    conv = Ev("aten::conv2d", 10, 20, resnet, seq=1)
    Ev("cudaLaunchKernel", 12, 13, conv)
    gn = _launcher("aten::group_norm", 30, 40, resnet, "cudaLaunchKernel", 32)
    sdpa = Ev("aten::_scaled_dot_product_cudnn_attention", 160, 170, attn, seq=2)
    Ev("cudaLaunchKernel", 162, 163, sdpa)
    dconv = _launcher("aten::conv2d", 310, 320, dec, "cudaLaunchKernel", 312)
    bn = Ev("aten::batch_norm", 330, 350, dec, seq=3)
    nbn = _launcher("aten::native_batch_norm", 331, 349, bn, "cudaLaunchKernel", 340)
    node = Ev("autograd::engine::evaluate_function: NativeBatchNormBackward0", 600, 700, seq=3)
    bn_bwd = _launcher("aten::native_batch_norm_backward", 601, 699, node, "cudaLaunchKernel", 610)
    cnode = Ev("autograd::engine::evaluate_function: ConvolutionBackward0", 700, 800, seq=1)
    conv_bwd = _launcher("aten::convolution_backward", 701, 799, cnode, "cudaLaunchKernel", 710)
    ops = [(14, 34, "sm90_xmma_fprop", conv), (34, 44, "GroupNormKernel", gn),
           (164, 204, "cudnn_sdpa_fprop", sdpa), (314, 334, "sm90_xmma_fprop", dconv),
           (342, 352, "batch_norm_collect_statistics", nbn),
           (612, 642, "batch_norm_backward_kernel", bn_bwd),
           (712, 752, "sm90_xmma_dgrad", conv_bwd)]
    return _trace(ops, 1000 * US)


def test_transunet_readers_charge_their_layer():
    tr = _transunet_step()
    busy = tr.busy_s
    assert busy == pytest.approx(170 * US, abs=1e-12)
    assert _read(CELL, "resnet_share.transunet", tr) == pytest.approx(100 * 70 / 170)
    assert _read(CELL, "decoder_share.transunet", tr) == pytest.approx(100 * 60 / 170)
    assert _read(CELL, "vit_share.transunet", tr) == pytest.approx(100 * 40 / 170)
    assert _read(CELL, "bn_share.transunet", tr) == pytest.approx(100 * 40 / 170)
    conf = json.loads((REPO / "benchmark/configs/transunet-r50b16-1024.json").read_text())
    peak = PEAKS["NVIDIA H100 80GB HBM3"]
    work = {"train_steps": 1, "val_batches": 0, "batch": 8, "size": 1024, "model": conf["model"]}
    ctx = SimpleNamespace(trace=tr, work=work, peak=peak)
    got = R.reader_of(R.load_cell(CELL), "conv_roofline.transunet").read(ctx)
    bound = Y.conv_bound_seconds(conf["model"], 1024, 8, peak, 1, 0)
    assert got == pytest.approx(100 * bound / (80 * US))


@pytest.mark.parametrize("metric", ["resnet_share.transunet", "decoder_share.transunet",
                                    "bn_share.transunet", "conv_roofline.transunet"])
def test_transunet_readers_read_nothing_without_their_layer(metric):
    """No trace, a trace with no span, or the U-Net's trace (no BatchNorm,
    no model in the work): no reading, and nothing raised."""
    bare = _trace([(3, 10, "kernel", Ev("aten::relu", 0, 5))], 20 * US)
    for trace in (None, bare, _trace([], 20 * US)):
        assert _read(CELL, metric, trace) is None
