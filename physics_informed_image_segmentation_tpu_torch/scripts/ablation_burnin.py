"""``--ablation all`` burn-in with a mid-study crash, on the card.

Counterpart of the JAX repo's ``scripts/ablation_burnin.py``.  It drives the
full 6-study, 29-training ``--ablation all`` through the port's CLI
(``python -m physics_informed_image_segmentation_tpu_torch.run_ablation``)
at the JAX script's budget: U-Net base 64, 128x128, batch 8, 3+3 epochs,
patience 5, 48/16/16+16 synthetic COCO images.  Subcommands, in order:

    data     write the dataset (the JAX script's splits and seeds)
    twice    the uninterrupted run twice; the largest |difference| over every
             numeric leaf of the study aggregates (a measurement: it fails
             only if a run fails)
    run-a    the uninterrupted run (the ground truth)
    run-b    the same run, SIGKILLed once the third study (R3) has written its
             first variant results JSON and before it has written all of
             them, then relaunched with ``--resume latest``
    batched  S1-S3 through ``--batched``, for the wall-clock table
    report   run-b's study aggregates against run-a's: equal bit for bit after
             the JAX script's path and timestamp fields are stripped, or the
             subcommand fails; the wall-clock table and per-study durations

    python -m physics_informed_image_segmentation_tpu_torch.scripts.ablation_burnin data
    python -m physics_informed_image_segmentation_tpu_torch.scripts.ablation_burnin twice

Each run is a fresh process started as ``python -c <bootstrap> <argv>``: the
bootstrap calls ``run_ablation.main(argv)`` and prints K1's launch counts
when it returns (a killed process prints none).  With ``--launch
deterministic`` it first calls ``torch.use_deterministic_algorithms(True)``
(an operation without a deterministic version raises) and sets
``torch.backends.cudnn.benchmark = False``, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment; ``--launch plain``
is the CLI as it stands.  ``twice`` defaults to ``plain``, the other runs
to :data:`LAUNCH`, the launch whose two runs were bit-equal on the card.

The kernels are built before the first launch, so that no SIGKILL lands
inside a build.  The dataset goes to ``$TMPDIR/torch_burnin_data`` and the
runs to ``$TMPDIR/torch_burnin_runs``; a finished run's ``.pth`` files are
deleted (the aggregates are what is compared), and ``report`` writes
``REPORT.md`` and the stripped aggregates there.  Every subcommand prints
JSON lines with the card's name and power limit.

On the GPU by default, raising without one (``--device cpu`` runs the same
workload on the host).  A smaller burn-in (one study, fewer images, epochs
or channels) is a :class:`Burnin` with other fields, driven through
:func:`make_data`, :func:`run_a`, :func:`run_b` and :func:`report`.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..data import write_synthetic_coco
from ..experiments import ALL_STUDIES
from ..utils.device import resolve_device
from ..utils.measure import build_kernels, device_facts

__all__ = ["SPLITS", "STRIP", "LAUNCH", "Burnin", "make_data", "bootstrap", "launch", "run_a",
           "run_b", "twice", "run_batched", "report", "aggregates", "scrub", "leaf_gap",
           "kill_mid_study", "main"]

PKG = "physics_informed_image_segmentation_tpu_torch"
REPO = Path(__file__).resolve().parents[2]
STUDIES = tuple(ALL_STUDIES)  # R1-R3, S1-S3: the order of `--ablation all`

# the JAX script's distribution-shift recipe, splits and seeds
IN_DIST = dict(r_range=(0.04, 0.16), cells_range=(1, 6),
               fg_range=(130.0, 190.0), blur_sigma=1.0)
OUT_DIST = dict(r_range=(0.10, 0.22), cells_range=(4, 9),
                fg_range=(110.0, 160.0), blur_sigma=1.5)
SPLITS = {
    "training": (48, 1, IN_DIST),
    "validation": (16, 2, IN_DIST),
    "in_dist_testing": (16, 3, IN_DIST),
    "out_dist_testing": (16, 4, OUT_DIST),
}
SIZE = 128
EPOCHS = 3
PATIENCE = 5
BASE_CHANNELS = 64
KILL_ON = "R3"  # in an `all` run: SIGKILL once this study has >= 1 variant JSON
POLL_S = 0.02

# the JAX script's stripped fields: paths and timestamps, nothing else
STRIP = ("model_path", "pde_model_path", "baseline_model_path", "timestamp")

LAUNCHES = ("plain", "deterministic")
LAUNCH = "plain"


@dataclass
class Burnin:
    """One burn-in's settings: where its data and runs live, the study
    (``all`` or one of R1-S3), and the CLI's arguments."""

    data_root: Path = field(default_factory=lambda: Path(tempfile.gettempdir()) / "torch_burnin_data")
    work: Path = field(default_factory=lambda: Path(tempfile.gettempdir()) / "torch_burnin_runs")
    ablation: str = "all"
    images: tuple = tuple(n for n, _, _ in SPLITS.values())
    size: int = SIZE
    epochs: int = EPOCHS
    base_channels: int = BASE_CHANNELS
    precision: str = "bf16"
    device: str = "cuda"
    launch: str = LAUNCH

    @property
    def studies(self) -> list:
        return list(STUDIES) if self.ablation == "all" else [self.ablation]

    @property
    def kill_on(self) -> str:
        return KILL_ON if self.ablation == "all" else self.ablation

    @property
    def kill_on_variants(self) -> int:
        return len(ALL_STUDIES[self.kill_on]())

    def cli_args(self, ablation: str) -> list:
        """The ``run_ablation`` arguments: the JAX script's ``HP`` and the width."""
        return ["--ablation", ablation, "--batch-size", "8", "--learning-rate", "1e-4",
                "--stage1-epochs", str(self.epochs), "--stage2-epochs", str(self.epochs),
                "--early-stopping-patience", str(PATIENCE),
                "--base-channels", str(self.base_channels), "--precision", self.precision,
                "--device", self.device]


def make_data(cfg: Burnin) -> None:
    """The dataset in the CLI's layout, split by split as the JAX script
    writes it (``write_synthetic_coco`` with its seeds and recipes)."""
    root = cfg.data_root
    img = root / "images"
    shutil.rmtree(root, ignore_errors=True)
    (img / "annotation").mkdir(parents=True)
    for (split, (_, seed, kw)), n in zip(SPLITS.items(), cfg.images):
        stage = root / f"_stage_{split}"
        image_dir, ann_path = write_synthetic_coco(stage, n=n, height=cfg.size, width=cfg.size,
                                                   seed=seed, **kw)
        shutil.move(str(image_dir), img / split)
        shutil.move(str(ann_path), img / "annotation" / f"{split}_annotation.json")
        shutil.rmtree(stage)


def bootstrap(deterministic: bool) -> str:
    """The program each run starts as ``python -c``: ``run_ablation.main``
    on ``sys.argv[1:]``, then K1's launch counts."""
    lines = ["import json, sys", "import torch"]
    if deterministic:
        lines += ["torch.use_deterministic_algorithms(True)",
                  "torch.backends.cudnn.benchmark = False"]
    lines += [f"from {PKG} import run_ablation",
              f"from {PKG}.ops import physics_kernel",
              "run_ablation.main(sys.argv[1:])",
              "print('[burnin] K1 launches ' + json.dumps(physics_kernel.launch_counts), "
              "flush=True)"]
    return "\n".join(lines)


def launch(cwd: Path, argv: list, launch_kind: str) -> subprocess.Popen:
    """Start one CLI run in ``cwd``, its output appended to ``cwd/run.log``."""
    if launch_kind not in LAUNCHES:
        raise ValueError(f"launch must be one of {LAUNCHES}; got {launch_kind!r}")
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    if launch_kind == "deterministic":
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    with open(cwd / "run.log", "a") as log:
        return subprocess.Popen(
            [sys.executable, "-c", bootstrap(launch_kind == "deterministic"), *argv],
            cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT)


def _fresh_run_dir(cfg: Burnin, name: str) -> Path:
    d = cfg.work / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "images").symlink_to(cfg.data_root / "images")
    return d


def _wait(p: subprocess.Popen, cwd: Path, what: str) -> None:
    rc = p.wait()
    if rc != 0:
        raise RuntimeError(f"{what} failed with rc={rc}; see {cwd / 'run.log'}")


def _prune_weights(cwd: Path) -> None:
    """A finished run's checkpoints: ~82 MB each at base 64, two a variant."""
    for p in (cwd / "output").rglob("*.pth"):
        p.unlink()


def _record(cfg: Burnin, name: str, entry: dict) -> dict:
    """Add ``entry`` under ``name`` to ``work/runs.json`` and print it as a line."""
    path = cfg.work / "runs.json"
    runs = json.loads(path.read_text()) if path.exists() else {}
    runs[name] = entry
    path.write_text(json.dumps(runs, indent=1))
    print(json.dumps({"run": name, **entry}), flush=True)
    return entry


def _run_uninterrupted(cfg: Burnin, name: str, launch_kind: str, facts: dict) -> dict:
    cwd = _fresh_run_dir(cfg, name)
    started = datetime.datetime.now().isoformat(timespec="seconds")
    t0 = time.perf_counter()
    _wait(launch(cwd, cfg.cli_args(cfg.ablation), launch_kind), cwd, name)
    wall = time.perf_counter() - t0
    _prune_weights(cwd)
    return _record(cfg, name, {"launch": launch_kind, "wall_s": wall, "started": started,
                               "k1_launches": _k1_counts(cwd), "card": facts["card"]})


def _k1_counts(cwd: Path) -> list:
    """K1's counts from each finished process of a run (``run.log``)."""
    tag = "[burnin] K1 launches "
    return [json.loads(line[len(tag):]) for line in (cwd / "run.log").read_text().splitlines()
            if line.startswith(tag)]


def _variant_jsons(cwd: Path, study: str) -> list:
    return [f for d in (cwd / "output" / "ablation").glob(f"{study}_*")
            for f in d.glob("*_results.json")]


def kill_mid_study(p: subprocess.Popen, cwd: Path, study: str, n_variants: int,
                   poll_s: float = POLL_S) -> int:
    """SIGKILL ``p`` once ``study`` has written its first variant results
    JSON; returns how many it had when the process died.  Raises when the
    process ends before that, or when the kill found the study complete:
    the crash must land mid-study."""
    while p.poll() is None:
        if _variant_jsons(cwd, study):
            os.kill(p.pid, signal.SIGKILL)
            p.wait()
            done = len(_variant_jsons(cwd, study))
            if not 1 <= done < n_variants:
                raise RuntimeError(f"the kill landed with {done} of {n_variants} {study} "
                                   "variants written: not mid-study")
            return done
        time.sleep(poll_s)
    raise RuntimeError(f"the run ended (rc={p.returncode}) before {study} wrote a variant: "
                       "the kill trigger never fired")


def run_a(cfg: Burnin, facts: dict) -> dict:
    return _run_uninterrupted(cfg, "run_a", cfg.launch, facts)


def run_b(cfg: Burnin, facts: dict) -> dict:
    cwd = _fresh_run_dir(cfg, "run_b")
    started = datetime.datetime.now().isoformat(timespec="seconds")
    t0 = time.perf_counter()
    p = launch(cwd, cfg.cli_args(cfg.ablation), cfg.launch)
    done = kill_mid_study(p, cwd, cfg.kill_on, cfg.kill_on_variants)
    killed_at = time.perf_counter() - t0
    print(json.dumps({"killed": "run_b", "study": cfg.kill_on, "variants_written": done,
                      "of": cfg.kill_on_variants, "after_s": killed_at}), flush=True)
    _wait(launch(cwd, [*cfg.cli_args(cfg.ablation), "--resume", "latest"], cfg.launch),
          cwd, "run_b --resume latest")
    wall = time.perf_counter() - t0
    _prune_weights(cwd)
    return _record(cfg, "run_b", {"launch": cfg.launch, "wall_s": wall, "started": started,
                                  "killed_in": cfg.kill_on, "variants_at_kill": done,
                                  "killed_after_s": killed_at, "k1_launches": _k1_counts(cwd),
                                  "card": facts["card"]})


def run_batched(cfg: Burnin, facts: dict) -> dict:
    """S1-S3 through the batched sweep, one process a study."""
    cwd = _fresh_run_dir(cfg, "run_batched")
    walls = {}
    for study in ("S1", "S2", "S3"):
        t0 = time.perf_counter()
        _wait(launch(cwd, [*cfg.cli_args(study), "--batched"], cfg.launch), cwd,
              f"batched {study}")
        walls[study] = time.perf_counter() - t0
    _prune_weights(cwd)
    return _record(cfg, "run_batched", {"launch": cfg.launch, "wall_s": sum(walls.values()),
                                        "study_wall_s": walls, "card": facts["card"]})


def scrub(obj):
    """``obj`` without the :data:`STRIP` fields, at any depth."""
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items() if k not in STRIP}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


def aggregates(run_dir: Path) -> dict:
    """Every study's aggregate JSON of a run, stripped, by study name."""
    out = {}
    for study_dir in sorted((run_dir / "output" / "ablation").iterdir()):
        study = study_dir.name.split("_")[0]
        js = [f for f in study_dir.glob(f"ablation_{study}_*.json") if "_summary" not in f.name]
        if len(js) != 1:
            raise RuntimeError(f"{study_dir}: expected one aggregate JSON, found {js}")
        out[study] = scrub(json.loads(js[0].read_text()))
    return out


def _same(a, b) -> bool:
    """Equal bit for bit, NaN at the same place counting as equal: the
    canonical JSON text (a float's ``repr`` is exact)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def leaf_gap(a, b) -> tuple[float, int, int]:
    """(largest |a - b| over the numeric leaves, leaves that differ, leaves).
    NaN against NaN is a gap of 0, NaN against a number an infinite one;
    a difference of structure, type or string is an infinite gap."""
    if isinstance(a, dict) and isinstance(b, dict):
        if sorted(a) != sorted(b):
            return math.inf, 1, 1
        parts = [leaf_gap(a[k], b[k]) for k in a]
    elif isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return math.inf, 1, 1
        parts = [leaf_gap(x, y) for x, y in zip(a, b)]
    elif (isinstance(a, (int, float)) and isinstance(b, (int, float))
          and not isinstance(a, bool) and not isinstance(b, bool)):
        if math.isnan(a) or math.isnan(b):
            gap = 0.0 if math.isnan(a) and math.isnan(b) else math.inf
        elif a == b:
            gap = 0.0
        else:
            gap = abs(a - b)
        return gap, int(gap != 0.0), 1
    else:
        return (0.0, 0, 1) if a == b else (math.inf, 1, 1)
    return (max((p[0] for p in parts), default=0.0), sum(p[1] for p in parts),
            sum(p[2] for p in parts))


def _expected_variants(cfg: Burnin) -> dict:
    return {s: len(ALL_STUDIES[s]()) for s in cfg.studies}


def _check_studies(cfg: Burnin, aggs: dict, run: str) -> dict:
    n_var = {s: len(a["results"]) for s, a in aggs.items()}
    if n_var != _expected_variants(cfg):
        raise RuntimeError(f"{run}: variants per study {n_var}, expected "
                           f"{_expected_variants(cfg)}")
    return n_var


def twice(cfg: Burnin, facts: dict, launch_kind: str = "plain") -> dict:
    """The uninterrupted run twice, in two fresh processes one after the
    other; returns (and prints) the gap between their aggregates."""
    names = [f"twice_{launch_kind}_{i}" for i in (1, 2)]
    for name in names:
        _run_uninterrupted(cfg, name, launch_kind, facts)
    a, b = (aggregates(cfg.work / name) for name in names)
    _check_studies(cfg, a, names[0])
    _check_studies(cfg, b, names[1])
    by_study = {}
    for s in cfg.studies:
        gap, differ, leaves = leaf_gap(a[s], b[s])
        by_study[s] = {"equal": _same(a[s], b[s]), "max_abs_diff": gap,
                       "leaves_differing": differ, "leaves": leaves}
    line = {"twice": launch_kind, "equal_studies": sum(v["equal"] for v in by_study.values()),
            "studies": len(by_study),
            "max_abs_diff": max(v["max_abs_diff"] for v in by_study.values()),
            "by_study": by_study, "card": facts["card"]}
    gaps_path = cfg.work / "twice.json"
    gaps = json.loads(gaps_path.read_text()) if gaps_path.exists() else {}
    gaps[launch_kind] = line
    gaps_path.write_text(json.dumps(gaps, indent=1))
    print(json.dumps(line), flush=True)
    return line


def _study_durations(run_dir: Path, total_s: float, started: str) -> dict:
    """Seconds of each study within a run, from the timestamps in the study
    folders' names (one-second resolution; the last is bounded by the run's
    wall time), and the seconds from the launch to the first study folder."""
    times = []
    for d in sorted((run_dir / "output" / "ablation").iterdir()):
        study, ts = d.name.split("_", 1)
        times.append((study, datetime.datetime.strptime(ts, "%Y%m%d_%H%M%S")))
    durs = {s: (t1 - t0).total_seconds() for (s, t0), (_, t1) in zip(times, times[1:])}
    launched = datetime.datetime.fromisoformat(started)
    done = (times[-1][1] - launched).total_seconds()
    durs[times[-1][0]] = max(total_s - done, 0.0)
    return {"studies": durs, "to_first_study_s": (times[0][1] - launched).total_seconds()}


def report(cfg: Burnin, facts: dict) -> dict:
    """run-b's aggregates against run-a's; raises unless every study's is
    equal bit for bit after :data:`STRIP`."""
    a, b = aggregates(cfg.work / "run_a"), aggregates(cfg.work / "run_b")
    if sorted(a) != sorted(cfg.studies) or sorted(b) != sorted(cfg.studies):
        raise RuntimeError(f"studies run_a {sorted(a)}, run_b {sorted(b)}; expected "
                           f"{sorted(cfg.studies)}")
    n_var = _check_studies(cfg, a, "run_a")
    _check_studies(cfg, b, "run_b")
    mismatches = [s for s in cfg.studies if not _same(a[s], b[s])]
    runs = json.loads((cfg.work / "runs.json").read_text())
    gaps_path = cfg.work / "twice.json"
    gaps = json.loads(gaps_path.read_text()) if gaps_path.exists() else {}
    for s in cfg.studies:
        (cfg.work / f"run_a_{s}.json").write_text(json.dumps(a[s], indent=1))
        (cfg.work / f"run_b_{s}.json").write_text(json.dumps(b[s], indent=1))
    ra, rb = runs["run_a"], runs["run_b"]
    durations = _study_durations(cfg.work / "run_a", ra["wall_s"], ra["started"])
    n = len(cfg.studies)
    lines = [
        f"# `--ablation {cfg.ablation}` burn-in with a mid-study crash (PyTorch port)",
        "",
        f"`--ablation {cfg.ablation}` ({sum(n_var.values())} variants) through the port's CLI "
        f"on {facts['card']}: base {cfg.base_channels}, {cfg.size}x{cfg.size}, batch 8, "
        f"{cfg.epochs}+{cfg.epochs} epochs, patience {PATIENCE}, "
        f"{'/'.join(str(i) for i in cfg.images)} images, {cfg.precision}.",
        "",
        f"- launch: `{ra['launch']}` for run A and run B.",
        "- run A: uninterrupted.",
        f"- run B: SIGKILLed {rb['killed_after_s']:.1f} s in, with {rb['variants_at_kill']} of "
        f"{cfg.kill_on_variants} {cfg.kill_on} variant JSONs written, then "
        "relaunched with `--resume latest`.",
        "",
        f"**Aggregate equality**: {n - len(mismatches)}/{n} study aggregate JSONs identical "
        f"after stripping {', '.join(STRIP)}"
        + (f": MISMATCH in {mismatches}." if mismatches else " (bit for bit)."),
        "",
    ]
    for kind, g in sorted(gaps.items()):
        lines.append(f"Two uninterrupted runs under the `{kind}` launch: {g['equal_studies']}/"
                     f"{g['studies']} aggregates equal, largest |difference| over the numeric "
                     f"leaves {g['max_abs_diff']!r}.")
    lines += ["", "| run | launch | wall-clock |", "|---|---|---|"]
    lines += [f"| {k} | {v['launch']} | {v['wall_s']:.1f} s |" for k, v in sorted(runs.items())]
    lines += [
        "",
        f"Variants per study: {n_var}.",
        "",
        "Per-study durations within run A (from the study folders' timestamped names): "
        + ", ".join(f"{s} {d:.0f} s" for s, d in durations["studies"].items())
        + f"; the first study folder appeared {durations['to_first_study_s']:.0f} s after the "
        "launch (the process's start: imports, the CUDA context, the datasets' decode).",
    ]
    text = "\n".join(lines) + "\n"
    (cfg.work / "REPORT.md").write_text(text)
    print(text, end="")
    line = {"report": f"{n - len(mismatches)}/{n}", "mismatches": mismatches,
            "launch": ra["launch"], "variants": n_var, "wall_s": {k: v["wall_s"]
                                                                 for k, v in runs.items()},
            "study_s": durations["studies"], "to_first_study_s": durations["to_first_study_s"],
            "twice_max_abs_diff": {k: g["max_abs_diff"] for k, g in gaps.items()},
            "card": facts["card"]}
    print(json.dumps(line), flush=True)
    if mismatches:
        raise RuntimeError(f"aggregate mismatch: {mismatches}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=["data", "twice", "run-a", "run-b", "batched", "report"])
    ap.add_argument("--launch", choices=LAUNCHES, default=None,
                    help=f"default: plain for twice, {LAUNCH} for the other runs")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = Burnin(device=dev.type, launch=args.launch or LAUNCH)
    facts = device_facts(dev)
    if args.command == "data":
        make_data(cfg)
        print(json.dumps({"data": str(cfg.data_root), "images": dict(zip(SPLITS, cfg.images)),
                          "size": cfg.size}), flush=True)
        return 0
    if args.command == "report":
        report(cfg, facts)
        return 0
    if not (cfg.data_root / "images" / "out_dist_testing").is_dir():
        raise FileNotFoundError(f"no dataset at {cfg.data_root}: run the 'data' subcommand")
    cfg.work.mkdir(parents=True, exist_ok=True)
    build_kernels(dev)  # every kernel built before a launch: no kill inside a build
    if args.command == "twice":
        twice(cfg, facts, args.launch or "plain")
    else:
        {"run-a": run_a, "run-b": run_b, "batched": run_batched}[args.command](cfg, facts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
