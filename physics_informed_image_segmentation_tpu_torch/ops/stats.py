"""Host-side statistics of per-image metric arrays (NumPy/SciPy).

Counterpart of ``physics_informed_image_segmentation_tpu/ops/stats.py``:
NaN-filtered mean/std/count, the paired model comparison (t-test and
Wilcoxon signed-rank, "significant" if either p-value is below alpha) and
the mean ± std text report.  These run on the host after evaluation.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["compute_statistics", "compare_models_statistically", "format_metric_report"]


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


def compare_models_statistically(
    metrics_baseline: Dict[str, np.ndarray],
    metrics_pde: Dict[str, np.ndarray],
    alpha: float = 0.05,
) -> Dict[str, Dict[str, float]]:
    """Paired t-test and two-sided Wilcoxon signed-rank test per metric.

    Pairs with a NaN on either side are dropped.  Fewer than 2 valid pairs
    give a row of NaN statistics (not significant).  All-zero differences,
    where ``wilcoxon`` raises, give the Wilcoxon pair (0.0, 1.0).
    ``improvement`` is the PDE mean minus the baseline mean.
    """
    from scipy import stats

    results: Dict[str, Dict[str, float]] = {}
    for metric_name in metrics_baseline.keys():
        base = np.asarray(metrics_baseline[metric_name], dtype=np.float64)
        pde = np.asarray(metrics_pde[metric_name], dtype=np.float64)
        valid = ~(np.isnan(base) | np.isnan(pde))
        base_clean, pde_clean = base[valid], pde[valid]

        if len(base_clean) < 2:
            results[metric_name] = {
                "t_statistic": np.nan,
                "t_pvalue": np.nan,
                "wilcoxon_statistic": np.nan,
                "wilcoxon_pvalue": np.nan,
                "significant": False,
                "baseline_mean": np.nan,
                "baseline_std": np.nan,
                "pde_mean": np.nan,
                "pde_std": np.nan,
                "improvement": np.nan,
            }
            continue

        t_stat, t_pvalue = stats.ttest_rel(base_clean, pde_clean)
        try:
            w_stat, w_pvalue = stats.wilcoxon(base_clean, pde_clean, alternative="two-sided")
        except ValueError:  # all differences zero
            w_stat, w_pvalue = 0.0, 1.0

        base_stats = compute_statistics(base_clean)
        pde_stats = compute_statistics(pde_clean)
        results[metric_name] = {
            "t_statistic": float(t_stat),
            "t_pvalue": float(t_pvalue),
            "wilcoxon_statistic": float(w_stat),
            "wilcoxon_pvalue": float(w_pvalue),
            "significant": bool((t_pvalue < alpha) or (w_pvalue < alpha)),
            "baseline_mean": base_stats["mean"],
            "baseline_std": base_stats["std"],
            "pde_mean": pde_stats["mean"],
            "pde_std": pde_stats["std"],
            "improvement": float(np.mean(pde_clean) - np.mean(base_clean)),
        }
    return results


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
