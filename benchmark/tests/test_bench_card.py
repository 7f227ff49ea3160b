"""One short run of each cell on the card, as the benchmark's command
line makes it, and the contract's shape of its result line."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_one_short_run(card, cell, trace):
    out = subprocess.run([sys.executable, "-m", "benchmark", "--workload", cell, "--seed",
                          str(2 ** 31 + 5), "--seconds", "3", "--trace", str(trace)],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    names = [m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
             if cell in m.get("workloads", [cell])]
    assert set(result["metrics"]) <= set(names)
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    else:
        assert set(result["metrics"]) == set(names)
    assert list(result)[-1] == "compared"
