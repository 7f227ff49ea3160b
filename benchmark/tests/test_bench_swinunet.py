"""The Swin-Unet cell on the CPU: a whole run of a tiny copy of
``train-swinunet-896-b8`` (224 x 224 images, embed_dim 24, float32, the real
cell's limits) is ``correct``, and a fault planted in the port makes it
incorrect; the window's work counts the attention and the windows as the
yardstick does; the yardstick's operations and bytes against counts made by
hand at a small size, and its count of a forward at the published widths;
the cell loads by name with every reader; the readers charge each layer of
a made-up trace, and read nothing where their layer is not."""

from __future__ import annotations

import json
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import run as R
from benchmark import yardstick_swinunet as Y

from .test_bench_faults import _half_batch, _unchanged
from .test_bench_spans import US, Ev, _launcher, _read, _trace
from .tiny import REPO

CELL = "train-swinunet-896-b8"
SMALL = dict(embed_dim=24, num_heads=[1, 2, 4, 8], batch_size=2)
MIX = {"driver": "train_swinunet", "why": "tiny", "train_images": 8, "val_images": 4,
       "first_steps": 3, "trace_epochs": 1}
CONF = json.loads((REPO / "benchmark/configs/swinunet-tiny-896.json").read_text())
READERS = ["attn_roofline.swinunet", "mfu.swinunet", "window_share.swinunet",
           "resample_share.swinunet", "ln_share.swinunet"]
# a model of two stages small enough to count by hand: 8 x 8 images,
# patch 2 (a 4 x 4 map, then 2 x 2), window 2 (the second stage one window,
# unshifted), widths 8 and 16
HAND = dict(embed_dim=8, depths=[2, 2], num_heads=[1, 2], window_size=2, patch_size=2,
            mlp_ratio=4, n_classes=1)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _root(tmp):
    """The benchmark with a cell ``tiny-swinunet``: the real cell's
    configuration at 224 x 224 and small widths in float32, its limits and
    metrics."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads(json.dumps(CONF))
    conf["model"].update(SMALL)
    conf["image_size"], conf["precision"] = 224, "f32"
    (tmp / "benchmark/configs/tiny-swinunet.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny-swinunet", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/tiny-swinunet.json", "reduced": [],
                             "why": "tiny"})
    (tmp / "benchmark/traffic/tiny-swinunet.json").write_text(json.dumps(MIX))
    shutil.copy(REPO / f"benchmark/limits/{CELL}.json",
                tmp / "benchmark/limits/tiny-swinunet.json")
    bench["workloads"].append({"name": "tiny-swinunet", "config": "tiny-swinunet",
                               "traffic": "tiny-swinunet", "chips": 1, "why": "tiny"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append("tiny-swinunet")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch])
def test_a_fault_in_the_port_makes_the_swinunet_run_incorrect(tmp_path, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    spec = R.load_cell("tiny-swinunet", _root(tmp_path))
    result = R.run_cell(spec, 2 ** 31 + 79, 0.5, False, "cpu", time.perf_counter())
    assert result["correct"] is (fault is None), result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"] and "train_img_per_s" in result["metrics"]


def test_the_window_counts_the_attention(tmp_path):
    """The work a reader gets holds the model, the window's attention counts
    and its window counts: 14 calls a forward, 6 on a shifted map at 224²
    (the last stage is one window), the query-key pairs the yardstick
    counts, and the windows of each call."""
    spec = R.load_cell("tiny-swinunet", _root(tmp_path))
    ctx = SimpleNamespace(cell=spec.name, config=spec.config, traffic=spec.traffic,
                          seed=2 ** 31 + 80, device=torch.device("cpu"))
    work = R.driver_of(spec).setup(ctx).window(0.0, trace=True)["work"]
    model, b = work["model"], work["batch"]
    counts, windows = work["attention_counts"], work["window_counts"]
    forwards = counts["forwards"]
    assert forwards == work["train_steps"] + work["val_batches"] == 4 + 2
    calls = Y.attention_calls(model, 224)
    assert counts["calls"] == len(calls) * forwards == 14 * forwards
    assert counts["pairs"] == forwards * b * Y.attention_pairs(model, 224)
    assert windows == {"windows": forwards * b * sum(n // w ** 2 for n, _, _, w in calls),
                       "shifted": 6 * forwards}
    per = Y.window_counts(model, 224)
    assert windows == {"windows": forwards * b * per["windows"],
                       "shifted": forwards * per["shifted"]}


def test_yardstick_counts_by_hand():
    """Two stages at 8 x 8 (HAND): the operations of one image's forward,
    its query-key pairs and the attention's floor of a training step and
    of a validation batch, each worked out by hand."""
    assert Y.attention_calls(HAND, 8) == [(16, 8, 1, 2)] * 2 + [(4, 16, 2, 2)] * 2 + [
        (16, 8, 1, 2)] * 2
    # patch embedding 2*16*(3*2*2)*8; four blocks of 16 tokens at width 8 and
    # two of 4 at 16, each 2*L*C^2*(3 + 1 + 8); merging 2*4*32*16; the
    # expansion 2*4*16*32 and concat_back_dim 2*16*16*8; x4 2*16*8*128; head
    # 2*64*8
    assert Y.linear_flops(HAND, 8) == (3072 + 4 * 24576 + 2 * 24576 + 4096 + 4096 + 4096
                                       + 32768 + 1024)
    assert Y.attention_flops(HAND, 8) == 4 * (4 * 16 * 4 * 8) + 2 * (4 * 4 * 4 * 16)
    assert Y.forward_flops(HAND, 8, 3) == 3 * (Y.linear_flops(HAND, 8) + 10240)
    assert Y.step_flops(HAND, 8, 3) == 3 * Y.forward_flops(HAND, 8, 3)
    assert Y.attention_pairs(HAND, 8) == 4 * (16 * 1 * 4) + 2 * (4 * 2 * 4)
    # four windows at stage 1 (encoder and decoder, two blocks each), one at
    # stage 2; only stage 1's odd blocks shift
    assert Y.window_counts(HAND, 8) == {"windows": 4 * 4 + 2 * 1, "shifted": 2}
    # one image, a card of 4 operations and 1 byte a second: stage 1 moves
    # q, k, v, o (4 x 256 bytes) and a 128-byte bias forward (1152 bytes
    # over 512 s of operations), 8 x 256 + 128 backward; stage 2 4 x 128 + 64
    # and 8 x 128 + 64
    peak = {"flops": 4.0, "bytes": 1.0}
    step = 4 * (1152 + 2176) + 2 * (576 + 1088)
    assert Y.attention_bound_seconds(HAND, 8, 1, peak, 1, 0) == step
    assert Y.attention_bound_seconds(HAND, 8, 1, peak, 0, 1) == 4 * 1152 + 2 * 576
    # operations bind where the card has few: 2048 of stage 1's forward at 1
    fast = {"flops": 1.0, "bytes": 1e9}
    assert Y.attention_bound_seconds(HAND, 8, 1, fast, 0, 1) == Y.attention_flops(HAND, 8)


def test_yardstick_counts_the_published_forward():
    model, s = CONF["model"], CONF["image_size"]
    assert len(Y.attention_calls(model, s)) == 14
    assert Y.linear_flops(model, s) == pytest.approx(187.435e9, rel=1e-4)
    assert Y.attention_flops(model, s) == pytest.approx(6.8448e9, rel=1e-4)
    assert Y.step_flops(model, s, 8) == pytest.approx(4.6627e12, rel=1e-4)
    # sides 224, 112, 56, 28: 1,024, 256, 64 and 16 windows, every stage shifted
    assert Y.window_counts(model, s) == {"windows": 4 * (1024 + 256 + 64) + 2 * 16, "shifted": 7}


def test_the_cell_loads_with_every_reader():
    spec = R.load_cell(CELL)
    assert [m["name"] for m in spec.end_to_end] == ["train_img_per_s", "train_peak_gib",
                                                     "setup_s"]
    names = [m["name"] for m in spec.per_layer]
    assert names == ["device_idle.train", "k1_roofline.train", "objective_share.train",
                     "metrics_share.train", "optim_share.train", *READERS]
    for name in names:
        assert R.reader_of(spec, name).MOVES == "train_img_per_s"


def _swin_step():
    """A made-up training step of the Swin-Unet: a forward in its spans, a
    LayerNorm, and the backward of the attention on autograd's thread,
    charged back by ``sequence_nr``."""
    step = Ev("piis.epoch", 0, 1000)
    fw = Ev("piis.forward", 0, 500, step)
    enc, dec = Ev("piis.transformer", 0, 300, fw), Ev("piis.decoder", 300, 500, fw)
    ln = Ev("aten::layer_norm", 10, 30, enc)
    nln = _launcher("aten::native_layer_norm", 11, 29, ln, "cudaLaunchKernel", 12)
    win = Ev("piis.window", 40, 60, enc)
    roll = _launcher("aten::roll", 41, 59, win, "cudaLaunchKernel", 42)
    attn = Ev("piis.attention", 60, 80, enc)
    sdpa = Ev("aten::_scaled_dot_product_efficient_attention", 61, 79, attn, seq=7)
    Ev("cudaLaunchKernel", 62, 63, sdpa)
    res = Ev("piis.resample", 320, 360, dec)
    mm = _launcher("aten::addmm", 321, 359, res, "cudaLaunchKernel", 322)
    node = Ev("autograd::engine::evaluate_function: ScaledDotProductEfficientAttentionBackward0",
              600, 700, seq=7)
    bwd = _launcher("aten::_efficient_attention_backward", 601, 699, node, "cudaLaunchKernel",
                    610)
    ops = [(14, 34, "vectorized_layer_norm_kernel", nln), (44, 54, "roll_cuda_kernel", roll),
           (64, 84, "fmha_cutlassF_bf16", sdpa), (324, 364, "sm90_gemm", mm),
           (612, 652, "fmha_cutlassB_bf16", bwd)]
    return _trace(ops, 1000 * US)


def test_swinunet_readers_charge_their_layer():
    tr = _swin_step()
    busy = tr.busy_s
    assert busy == pytest.approx(130 * US, abs=1e-12)
    assert _read(CELL, "resample_share.swinunet", tr) == pytest.approx(100 * 40 / 130)
    assert _read(CELL, "ln_share.swinunet", tr) == pytest.approx(100 * 20 / 130)
    model, peak = CONF["model"], {"flops": 989.4e12, "bytes": 3.35e12}
    b, s = 8, CONF["image_size"]
    counts = {"calls": 14, "pairs": b * Y.attention_pairs(model, s), "forwards": 1}
    per = Y.window_counts(model, s)
    windows = {"windows": b * per["windows"], "shifted": per["shifted"]}
    work = {"train_steps": 1, "val_batches": 0, "batch": b, "size": s, "model": model,
            "attention_counts": counts, "window_counts": windows}
    spec = R.load_cell(CELL)
    ctx = SimpleNamespace(trace=tr, work=work, peak=peak)
    window_share = R.reader_of(spec, "window_share.swinunet")
    assert window_share.read(ctx) == pytest.approx(100 * 10 / 130)
    bound = Y.attention_bound_seconds(model, s, b, peak, 1, 0)
    got = R.reader_of(spec, "attn_roofline.swinunet").read(ctx)
    assert got == pytest.approx(100 * bound / (60 * US))  # forward 20 µs, backward 40 µs
    mfu = R.reader_of(spec, "mfu.swinunet").read(ctx)
    assert mfu == pytest.approx(100 * Y.step_flops(model, s, b) / tr.span_s / peak["flops"])
    # counts of another model (one call too few) read nothing
    ctx.work = dict(work, attention_counts=dict(counts, calls=13))
    assert R.reader_of(spec, "attn_roofline.swinunet").read(ctx) is None
    # window counts of another model (one shifted call too few) read nothing
    ctx.work = dict(work, window_counts=dict(windows, shifted=6))
    assert window_share.read(ctx) is None


@pytest.mark.parametrize("metric", READERS)
def test_swinunet_readers_read_nothing_without_their_layer(metric):
    """No trace, a trace with no span, or another model's trace (no
    LayerNorm, no model in the work): no reading, and nothing raised."""
    bare = _trace([(3, 10, "kernel", Ev("aten::relu", 0, 5))], 20 * US)
    for trace in (None, bare, _trace([], 20 * US)):
        assert _read(CELL, metric, trace) is None
