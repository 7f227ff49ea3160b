"""Run one benchmark cell once and print its result line.

    python -m benchmark --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its files are
found by name: the configuration (``configs[].file``), the traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names the module
under ``benchmark/drivers/`` that runs it), the limits of its check
(``benchmark/limits/<cell>.json``) and each per-layer metric's reader
(``benchmark/metrics/<metric>.py``).  A metric named ``<quantity>.<tag>``
that has no value or reader of its own takes those of ``<quantity>``
(``predict_img_per_s.b8`` is the driver's ``predict_img_per_s``): a
quantity is split by cell, each part with a bound of its own, without code.

A run: set-up (imports, inputs and weights from the seed, the program's
first steps or warm-up: ``setup_s``), the window of ``--seconds``, the
peak memory, the program freed, then the check against the plain
reference.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window.  The last line of standard output
is one JSON object; the last lines of standard error give each number
compared beside its limit.  Without a CUDA device (or with fewer than the
cell asks for), or with JAX or the JAX package loaded once the window has
closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that no benchmark process may hold: JAX and the JAX
# package (the port's name starts with the latter's: names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "physics_informed_image_segmentation_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything a run of cell ``name`` needs, from the files under ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = root / "benchmark"

    def listed(metric):
        return name in metric.get("workloads", [name])

    return SimpleNamespace(
        name=name, chips=cell["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((here / "limits" / f"{name}.json").read_text())["limits"],
        end_to_end=[m for m in bench["end_to_end"] if listed(m)],
        per_layer=[m for m in bench["per_layer"] if listed(m)],
        here=here,
    )


def driver_of(spec):
    return _load_module(spec.here / "drivers" / f"{spec.traffic['driver']}.py",
                        f"benchmark.drivers.{spec.traffic['driver']}")


def quantities(metric: str) -> list[str]:
    """``metric``, then each shorter name before a dot: where its value or
    reader is looked for, in that order."""
    parts = metric.split(".")
    return [".".join(parts[:k]) for k in range(len(parts), 0, -1)]


def reader_of(spec, metric: str):
    for name in quantities(metric):
        path = spec.here / "metrics" / f"{name}.py"
        if path.exists():
            return _load_module(path, f"benchmark_metric_{name}")
    raise FileNotFoundError(f"no reader for {metric!r} under {spec.here / 'metrics'}")


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def run_cell(spec, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``spec`` on ``device``; returns the result object (with
    the ``compared`` table last)."""
    import torch

    from .reference.steps import no_tf32
    from .trace import Trace
    from .yardstick import PEAKS

    ctx = SimpleNamespace(cell=spec.name, config=spec.config, traffic=spec.traffic,
                          seed=seed, device=torch.device(device))
    run = driver_of(spec).setup(ctx)
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            out = run.window(seconds, trace=True)
            if on_card:
                torch.cuda.synchronize()
    else:
        out = run.window(seconds, trace=False)
    peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    run.release()
    no_tf32()
    numbers = run.check()
    from .compare import verdict

    correct, compared = verdict(numbers, spec.limits)
    kind = torch.cuda.get_device_name(ctx.device) if on_card else "cpu"
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                         "count": spec.chips, "memory_peak_bytes": peak_bytes}}
    if trace:
        tr = Trace(prof, out["work"]["window_s"]) if on_card else None
        reading = SimpleNamespace(trace=tr, work=out["work"], peak=PEAKS.get(kind))
        for m in spec.per_layer:
            value = reader_of(spec, m["name"]).read(reading)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = tr.breakdown()
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in spec.end_to_end:
            found = [q for q in quantities(m["name"]) if q in values]
            if found:
                result["metrics"][m["name"]] = {"value": values[found[0]], "unit": m["unit"]}
    result["compared"] = compared
    return result


def _card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if not (ROOT / "BENCHMARK.json").exists():
        print("BENCHMARK.json not found beside the benchmark folder", file=sys.stderr)
        return 2
    spec = load_cell(args.workload)
    _fixed_caches()
    os.environ.setdefault("TMPDIR", tempfile.gettempdir())
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"needs {spec.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import physics_informed_image_segmentation_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is not here: {e}", file=sys.stderr)
        return 4
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    card = _card_line()
    print(f"card: {card}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {k: v for k, v in result.items() if k != "compared"} | {
        "card": card, "compared": result["compared"]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
