"""Readings that the limits of a cell's check are set from (not run by the
benchmark's own runs).

    python -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3]

In one process, for each seed: the cell's set-up, a traced run's window
(a training cell's ``trace_epochs``, a serving cell's ``pass_requests``),
the program freed, and the numbers the check compares (the lower
readings).  For a control seed, the same numbers with the reference in fp8
put in the program's place (the precision below the configuration's
bf16); for a fault seed of a training cell, with the reference leaving
out half of every batch, with its Boundary-F1 computed without the
tolerance, and with a batch of the window's epoch fed twice in place of
the next.  Prints one JSON line a seed, then one with the largest program
reading and the smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from types import SimpleNamespace

import torch

from .compare import leaf_gaps, train_numbers
from .run import _fixed_caches, driver_of, forbidden_modules, load_cell
from .reference.steps import no_tf32


FAULTS = ("half", "bf1", "repeat")


def _window_diff(got: dict, ref: dict) -> dict:
    """The median and the worst leaf's norm of the difference of the window
    epoch's changes (a reading of direction, beside the compared norms)."""
    gaps = leaf_gaps(got["window_changes"], ref["window_changes"], ref["grads"], diff=True)
    return {"median": statistics.median(gaps.values()), "max": max(gaps.values())}


def readings(spec, seed: int, control: bool, fault: bool, device="cuda") -> dict:
    ctx = SimpleNamespace(cell=spec.name, config=spec.config, traffic=spec.traffic,
                          seed=seed, device=torch.device(device))
    t0 = time.perf_counter()
    run = driver_of(spec).setup(ctx)
    run.window(0.0, trace=True)
    run.release()
    no_tf32()
    out = {"seed": seed, "program": run.check()}
    training = hasattr(run, "planted")
    if training:  # which leaves read worst, and how the window's change's direction reads
        prog = run.program()
        out["worst"] = {key: max(gaps, key=gaps.get) for key, gaps in (
            (key, leaf_gaps(prog[key], run.ref[key], run.ref["grads"]))
            for key in ("grads", "changes", "window_changes"))}
        out["window_diff"] = {"program": _window_diff(prog, run.ref)}
    if control:
        out["fp8"] = run.control("fp8")
    if fault and training:
        for kind in FAULTS:
            planted = run.planted(kind)
            out[kind] = train_numbers(planted, run.ref)
            out["window_diff"][kind] = _window_diff(planted, run.ref)
    out["seconds"] = time.perf_counter() - t0
    del run
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    _fixed_caches()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    spec = load_cell(args.workload)
    rows = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds + args.fault_seeds):
        row = readings(spec, seed, seed in args.control_seeds, seed in args.fault_seeds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": spec.name, "card": torch.cuda.get_device_name(0)}
    for kind, pick in (("program", max), ("fp8", min)) + tuple((f, min) for f in FAULTS):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {k: pick(g[k] for g in got) for k in got[0]}
    summary["forbidden_modules"] = forbidden_modules()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
