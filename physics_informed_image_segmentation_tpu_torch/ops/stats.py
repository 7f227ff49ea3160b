"""Host-side summary statistics of per-image metric arrays (NumPy).

The part of ``physics_informed_image_segmentation_tpu/ops/stats.py`` that
training and evaluation need: NaN-filtered mean/std/count and the
mean ± std text report.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["compute_statistics", "format_metric_report"]


def compute_statistics(metric_array: np.ndarray) -> Dict[str, float]:
    """NaN-filtered mean / sample-std / count."""
    arr = np.asarray(metric_array, dtype=np.float64)
    valid = arr[~np.isnan(arr)]
    if len(valid) == 0:
        return {"mean": np.nan, "std": np.nan, "count": 0}
    return {
        "mean": float(np.mean(valid)),
        "std": float(np.std(valid, ddof=1)) if len(valid) > 1 else 0.0,
        "count": len(valid),
    }


def format_metric_report(metrics: Dict[str, np.ndarray], model_name: str = "Model") -> str:
    """mean ± std text block, one line per metric."""
    lines = [f"\n{model_name} Performance:", "=" * 60]
    for metric_name, metric_array in metrics.items():
        s = compute_statistics(metric_array)
        title = metric_name.replace("_", " ").title()
        if s["count"] > 0:
            lines.append(f"{title}: {s['mean']:.4f} ± {s['std']:.4f} (n={s['count']})")
        else:
            lines.append(f"{title}: N/A")
    return "\n".join(lines)
