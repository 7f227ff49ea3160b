"""CSV / JSON metric persistence with the JAX package's exact schemas.

The 17-column per-epoch CSV header is byte-equal to the JAX package's
``EPOCH_CSV_FIELDS``; the file is rewritten after every epoch so a crash
leaves the latest complete table on disk.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List

import numpy as np

__all__ = ["EPOCH_CSV_FIELDS", "save_metrics_to_csv", "save_test_metrics"]

EPOCH_CSV_FIELDS = [
    "epoch",
    "train_loss",
    "train_dice_loss",
    "train_bce_loss",
    "train_pde_loss",
    "train_phase_field_loss",
    "train_dice_score",
    "train_iou_score",
    "train_boundary_f1_score",
    "val_loss",
    "val_dice_score",
    "val_dice_loss",
    "val_bce_loss",
    "val_pde_loss",
    "val_phase_field_loss",
    "val_iou_score",
    "val_boundary_f1_score",
]


def save_metrics_to_csv(metrics: List[Dict], csv_path) -> None:
    """Write the per-epoch metrics table."""
    if not metrics:
        return
    csv_path = Path(csv_path)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=EPOCH_CSV_FIELDS, extrasaction="ignore")
        writer.writeheader()
        writer.writerows(metrics)


def save_test_metrics(
    test_metrics: Dict[str, np.ndarray], output_path, model_name: str = "Model"
) -> None:
    """Persist per-image test metrics as paired CSV + JSON."""
    from ..ops.stats import compute_statistics

    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)

    stats_dict = {name: compute_statistics(arr) for name, arr in test_metrics.items()}
    json_path = output_path.with_suffix(".json")
    json_data = {
        "model_name": model_name,
        "statistics": {
            k: {"mean": float(v["mean"]), "std": float(v["std"]), "count": int(v["count"])}
            for k, v in stats_dict.items()
        },
        "per_image_metrics": {k: np.asarray(v).tolist() for k, v in test_metrics.items()},
    }
    with open(json_path, "w") as f:
        json.dump(json_data, f, indent=2)

    csv_path = output_path.with_suffix(".csv")
    fieldnames = list(test_metrics.keys())
    max_len = max(len(v) for v in test_metrics.values())
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        for i in range(max_len):
            row = {}
            for name in fieldnames:
                arr = test_metrics[name]
                v = float(arr[i]) if i < len(arr) else float("nan")
                row[name] = "" if not np.isfinite(v) else v
            writer.writerow(row)

    print("Test metrics saved to:")
    print(f"  CSV: {csv_path}")
    print(f"  JSON: {json_path}")
