"""The program's spans in a short traced window of each cell, on the card:
where its device time is charged, the clock offset against the
profiler's own start, and the idle split adding up to the device's idle
share.  Prints one JSON line a cell: every span's device and idle seconds."""

from __future__ import annotations

import json
from collections import defaultdict
from types import SimpleNamespace

import pytest

from benchmark import run as R
from benchmark.spans import PREFIX, spans_of

from .tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _traced_window(cell: str, seed: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import Trace

    spec = R.load_cell(cell)
    ctx = SimpleNamespace(cell=spec.name, config=spec.config, traffic=spec.traffic, seed=seed,
                          device=torch.device("cuda"))
    run = R.driver_of(spec).setup(ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = run.window(3.0, trace=True)
        torch.cuda.synchronize()
    run.release()
    return Trace(prof, out["work"]["window_s"]), prof


def _under(launcher, name: str) -> bool:
    while launcher is not None:
        if launcher.name == name:
            return True
        launcher = launcher.cpu_parent
    return False


def _chain(launcher) -> str:
    names = []
    while launcher is not None:
        names.append(f"{launcher.name[:48]}#{launcher.sequence_nr}@{launcher.thread}")
        launcher = launcher.cpu_parent
    return " < ".join(names) or "(no host operation)"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_spans_charge_the_window(card, cell):
    tr, prof = _traced_window(cell, 2 ** 31 + 17)
    sp = spans_of(tr)
    assert sp is not None
    total = sum(dt for dt, _, _ in sp.ops)
    charged = sum(dt for dt, _, span in sp.ops if span is not None)
    outside = defaultdict(float)  # device time charged to no span, or not under a request
    unlinked = 0.0  # device time the profiler linked to no host operation
    for (dt, name, span), (_, _, _, launcher) in zip(sp.ops, tr.ops):
        unlinked += dt if launcher is None else 0.0
        if span is None or (cell.startswith("predict") and not _under(launcher, "piis.predict")):
            outside[f"{name[:40]} <- {_chain(launcher)}"] += dt
    start_s = prof.profiler.kineto_results.trace_start_ns() * 1e-9
    idle = 100.0 * sum(sp.idle_s.values()) / tr.window_s
    device_idle = 100.0 * (1.0 - tr.busy_s / tr.window_s)
    by_span = defaultdict(lambda: defaultdict(float))
    for dt, name, span in sp.ops:
        by_span[str(span)][name[:60]] += dt
    top = {span: sorted(ops.items(), key=lambda kv: -kv[1])[:4] for span, ops in by_span.items()}
    roots = [ev for ev in prof.events() if ev.name.startswith(PREFIX) and ev.cpu_parent is None]
    first = min(min(ev.time_range.start for ev in roots) * 1e-6 + sp.offset_s,
                min(s for s, _, _, _ in tr.ops))
    last = max(max(ev.time_range.end for ev in roots) * 1e-6 + sp.offset_s,
               max(e for _, e, _, _ in tr.ops))
    print(json.dumps({
        "cell": cell, "window_s": tr.window_s, "busy_s": tr.busy_s, "device_idle": device_idle,
        "idle_split": idle, "offset_minus_trace_start_us": 1e6 * (sp.offset_s - start_s),
        "offset_pairs": sp.offset_pairs, "unlinked_share": unlinked / total,
        "charged_share": charged / total,
        "device_s": {str(k): v for k, v in sorted(sp.device_s.items(), key=lambda kv: -kv[1])},
        "idle_s": dict(sorted(sp.idle_s.items(), key=lambda kv: -kv[1])),
        "roots": len(roots), "window_beyond_spans_ms": 1e3 * (tr.window_s - (last - first)),
        "top_ops": top, "outside": sorted(outside.items(), key=lambda kv: -kv[1])[:8]}))
    # the spans are host operations: nothing of theirs is on the device's timeline
    assert not [n for _, _, n, _ in tr.ops if n.startswith(PREFIX)]
    # the profiler links a few device operations to no host operation
    assert unlinked < 1e-3 * total, unlinked
    if cell.startswith("predict"):  # every linked operation runs for a request
        assert sum(outside.values()) == pytest.approx(unlinked, abs=1e-9), outside
    else:
        assert charged >= 0.99 * total, (charged, total)
    assert abs(sp.offset_s - start_s) < 50e-6, sp.offset_s - start_s
    assert abs(idle - device_idle) < 0.5, (idle, device_idle)
