"""Swin-Unet on the card, in cell ``train-swinunet-896-b8``: in a short
traced window every block of every forward calls the window attention once,
seven of the fourteen calls a forward on a shifted map, and the device time
charged to span ``piis.attention`` (forward, and backward by
``sequence_nr``) is spent in fused attention kernels, none of it under a
matrix product or a softmax of the math path; and one whole run of the
cell is ``correct``.  Each test prints one JSON line.

    python -m pytest --noconftest -q -s benchmark/tests/test_bench_swinunet_card.py
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from types import SimpleNamespace

import pytest

from benchmark import run as R
from benchmark.spans import spans_of

from .test_bench_transunet_card import MATH, _chain

CELL = "train-swinunet-896-b8"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_window_attention_runs_fused_kernels_once_a_block(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import Trace

    spec = R.load_cell(CELL)
    ctx = SimpleNamespace(cell=spec.name, config=spec.config, traffic=spec.traffic,
                          seed=2 ** 31 + 25, device=torch.device("cuda"))
    run = R.driver_of(spec).setup(ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = run.window(3.0, trace=True)
        torch.cuda.synchronize()
    run.release()
    work = out["work"]
    tr = Trace(prof, work["window_s"])
    sp = spans_of(tr)
    kernels, math_path = defaultdict(float), []
    for (dt, name, span), (_, _, _, launcher) in zip(sp.ops, tr.ops):
        if span != "piis.attention":
            continue
        kernels[name[:90]] += dt
        chain = _chain(launcher)
        if any(m in host.lower() for host in chain for m in MATH):
            math_path.append((name[:60], chain[:3], dt))
    counts, windows = work["attention_counts"], work["window_counts"]
    print(json.dumps({"cell": CELL, "attention_counts": counts, "window_counts": windows,
                      "busy_s": tr.busy_s, "window_s": tr.window_s,
                      "spans_s": {s: sp.device((s,)) for s in (
                          "piis.transformer", "piis.decoder", "piis.attention", "piis.window",
                          "piis.resample", "piis.objective", "piis.optimizer", "piis.metrics")},
                      "kernels": sorted(kernels.items(), key=lambda kv: -kv[1])}))
    assert counts["calls"] == 14 * counts["forwards"] > 0
    assert windows["shifted"] == 7 * counts["forwards"]
    assert kernels and not math_path, math_path


@pytest.mark.cuda
def test_the_cell_is_correct_on_one_seed(card):
    spec = R.load_cell(CELL)
    result = R.run_cell(spec, 2 ** 31 + 1025, 3.0, False, "cuda", time.perf_counter())
    print(json.dumps({"cell": CELL, "correct": result["correct"], "metrics": result["metrics"],
                      "compared": result["compared"]}))
    assert result["correct"], result["compared"]
