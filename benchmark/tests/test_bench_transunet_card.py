"""TransUNet's attention on the card, in a short traced window of
``train-transunet-1024-b8``: every layer of every forward calls it once,
and the device time charged to span ``piis.attention`` (forward, and
backward by ``sequence_nr``) is spent in fused attention kernels, none of
it under a matrix product or a softmax of the math path.  Prints one JSON
line: the kernels charged to the span, with their seconds.

    python -m pytest --noconftest -q -s benchmark/tests/test_bench_transunet_card.py
"""

from __future__ import annotations

import json
from collections import defaultdict
from types import SimpleNamespace

import pytest

from benchmark import run as R
from benchmark.spans import spans_of

CELL = "train-transunet-1024-b8"
MATH = ("bmm", "softmax", "matmul", "baddbmm", "_math")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _chain(launcher) -> list[str]:
    names = []
    while launcher is not None:
        names.append(launcher.name)
        launcher = launcher.cpu_parent
    return names


@pytest.mark.cuda
def test_attention_runs_fused_kernels_once_a_layer(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import Trace

    spec = R.load_cell(CELL)
    ctx = SimpleNamespace(cell=spec.name, config=spec.config, traffic=spec.traffic,
                          seed=2 ** 31 + 23, device=torch.device("cuda"))
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
    counts = work["attention_counts"]
    print(json.dumps({"cell": CELL, "attention_counts": counts,
                      "attention_s": sp.device(("piis.attention",)),
                      "transformer_s": sp.device(("piis.transformer",)), "busy_s": tr.busy_s,
                      "kernels": sorted(kernels.items(), key=lambda kv: -kv[1])}))
    layers = spec.config["model"]["num_layers"]
    assert counts["calls"] == layers * counts["forwards"] > 0
    assert kernels and not math_path, math_path
