"""A copy of the benchmark with two tiny cells added as new files: the
cells ``train-1024-b8`` and ``predict-128-b128`` at base width 4 on 32 x 32
images, with the real cells' limit files, for runs on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TRAIN = {"driver": "train_stage", "why": "tiny", "train_images": 32, "val_images": 16,
         "first_steps": 3, "trace_epochs": 1}
PREDICT = {"driver": "predict", "why": "tiny", "source": "tiny", "pool_images": 256,
           "predictor_batch": 8, "request_images": 13, "pass_requests": 12, "threshold": 0.5,
           "check_requests": 3, "check_block": 16}


def make_root(tmp: Path, precision: str = "f32") -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``benchmark/`` as in the
    repository, plus the configuration ``tiny``, the mixes ``tiny-train``
    and ``tiny-predict``, the cells of those names (in the end-to-end and
    per-layer metrics of their kinds) and their limit files."""
    tmp.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / "benchmark/configs/unet64-128.json").read_text())
    conf["model"]["base_channels"], conf["image_size"], conf["precision"] = 4, 32, precision
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "benchmark/configs/tiny.json", "reduced": [],
                             "why": "tiny"})
    for cell, mix, like in (("tiny-train", TRAIN, "train-1024-b8"),
                            ("tiny-predict", PREDICT, "predict-128-b128")):
        (tmp / f"benchmark/traffic/{cell}.json").write_text(json.dumps(mix))
        shutil.copy(REPO / f"benchmark/limits/{like}.json", tmp / f"benchmark/limits/{cell}.json")
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": cell, "chips": 1,
                                   "why": "tiny"})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
