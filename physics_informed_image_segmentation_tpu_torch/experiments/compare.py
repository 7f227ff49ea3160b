"""Model-pair comparison: checkpoints → per-image metrics → statistics → files.

Counterpart of ``physics_informed_image_segmentation_tpu/experiments/compare.py``:
evaluate a baseline and a PDE checkpoint on a test set, run the paired
t-test and Wilcoxon, and write the per-image CSV, the summary CSV and the
comparison JSON; plus the comparison pooled over several seed-paired
checkpoint pairs.  The files have the JAX package's names and columns;
they are written with the ``csv`` module, as pandas would write them.
Evaluation runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data import DeviceDataset
from ..models import UNet
from ..ops.stats import compare_models_statistically, compute_statistics, format_metric_report
from ..train.checkpoint import load_params
from ..train.csvlog import save_rows_to_csv
from ..train.evaluation import evaluate_model
from ..train.loop import load_device_dataset
from ..utils.device import resolve_device, set_precision

__all__ = [
    "make_json_serializable",
    "load_unet_params",
    "evaluate_and_compare",
    "run_repeated_evaluations",
]

_METRIC_KEYS = ["dice_scores", "iou_scores", "boundary_f1_scores", "hausdorff_distances"]


def make_json_serializable(obj: Any) -> Any:
    """NumPy scalars and arrays and torch tensors → native Python types."""
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: make_json_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [make_json_serializable(v) for v in obj]
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    return str(obj)


def _precision(precision: Optional[str], dtype: Optional[str]) -> str:
    """The evaluation precision from ``precision`` or the JAX package's name
    for it, ``dtype`` ("bf16" when neither is given)."""
    if precision is not None and dtype is not None and precision != dtype:
        raise TypeError(f"precision={precision!r} and dtype={dtype!r} disagree; give one")
    return precision or dtype or "bf16"


def load_unet_params(
    model_path,
    model: Optional[UNet] = None,
    base_channels: int = 64,
    precision: Optional[str] = None,
    device=None,
    dtype: Optional[str] = None,
):
    """``(model, model)``: a U-Net on ``device`` holding the weights of a
    ``.pth`` checkpoint (into ``model`` when given).

    The pair unpacks as the JAX function's ``(model, params)`` does; here
    the module holds its parameters.  ``precision`` (or its JAX name
    ``dtype``) is the one the model will be evaluated in (``"f32"`` turns
    TF32 off).  A Flax ``.msgpack`` from the JAX package loads too.
    """
    device = resolve_device(device)
    set_precision(_precision(precision, dtype))
    if model is None:
        model = UNet(in_channels=1, out_channels=1, base_channels=base_channels)
    model = load_params(model_path, model.to(device))
    return model, model


def _print_comparison(comparison_results: dict) -> None:
    print("\nStatistical Test Results (α = 0.05):")
    print("-" * 70)
    for metric_name, r in comparison_results.items():
        print(f"\n{metric_name.replace('_', ' ').title()}:")
        print(f"  Baseline Mean: {r['baseline_mean']:.4f}")
        print(f"  PDE Mean:      {r['pde_mean']:.4f}")
        print(f"  Improvement:   {r['improvement']:+.4f}")
        print("  Paired t-test:")
        print(f"    t-statistic: {r['t_statistic']:.4f}")
        print(f"    p-value:     {r['t_pvalue']:.4f}")
        print("  Wilcoxon signed-rank test:")
        print(f"    statistic:   {r['wilcoxon_statistic']:.4f}")
        print(f"    p-value:     {r['wilcoxon_pvalue']:.4f}")
        print(f"  Significant:  {'Yes' if r['significant'] else 'No'}")


def evaluate_and_compare(
    baseline_model_path,
    pde_model_path,
    test_dir,
    test_json,
    batch_size: int = 8,
    threshold: float = 0.5,
    output_dir=None,
    test_data: Optional[DeviceDataset] = None,
    base_channels: int = 64,
    precision: Optional[str] = None,
    device=None,
    dtype: Optional[str] = None,
) -> Dict:
    """Evaluate both checkpoints, compare them and write
    ``evaluation_results_{ts}.csv`` (per image), ``evaluation_summary_{ts}.csv``
    (one row per metric) and ``statistical_comparison_{ts}.json``.

    ``test_data`` (a :class:`DeviceDataset`) skips reading ``test_dir`` /
    ``test_json``.  ``precision`` (or its JAX name ``dtype``): "bf16" (the
    default) or "f32"."""
    precision = _precision(precision, dtype)
    device = resolve_device(device)
    output_dir = Path(output_dir) if output_dir is not None else Path.cwd() / "output"
    output_dir.mkdir(parents=True, exist_ok=True)

    print("=" * 70)
    print("MODEL EVALUATION AND STATISTICAL COMPARISON")
    print("=" * 70)
    print("\nLoading models...")
    load = dict(base_channels=base_channels, precision=precision, device=device)
    baseline_model, _ = load_unet_params(baseline_model_path, **load)
    pde_model, _ = load_unet_params(pde_model_path, **load)

    test_data = (load_device_dataset(test_dir, test_json, device) if test_data is None
                 else test_data.to(device))

    print("\nEvaluating Baseline (Unconstrained) on test set...")
    baseline_metrics = evaluate_model(baseline_model, test_data, batch_size, threshold=threshold,
                                      precision=precision)
    print(format_metric_report(baseline_metrics, "Baseline (Unconstrained)"))
    print("\nEvaluating PDE-Constrained on test set...")
    pde_metrics = evaluate_model(pde_model, test_data, batch_size, threshold=threshold,
                                 precision=precision)
    print(format_metric_report(pde_metrics, "PDE-Constrained"))

    print("\n" + "=" * 70)
    print("STATISTICAL COMPARISON")
    print("=" * 70)
    comparison_results = compare_models_statistically(baseline_metrics, pde_metrics, alpha=0.05)
    _print_comparison(comparison_results)

    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    columns = {"dice": "dice_scores", "iou": "iou_scores", "boundary_f1": "boundary_f1_scores",
               "hausdorff": "hausdorff_distances"}
    rows = []
    for i in range(len(baseline_metrics["dice_scores"])):
        row = {"image_id": i}
        for short, key in columns.items():
            row[f"baseline_{short}"] = baseline_metrics[key][i]
            row[f"pde_{short}"] = pde_metrics[key][i]
        rows.append(row)
    results_csv = save_rows_to_csv(rows, output_dir / f"evaluation_results_{timestamp}.csv")
    print(f"\nPer-image metrics saved to: {results_csv}")

    summary_rows = []
    for metric_name in baseline_metrics:
        b = compute_statistics(baseline_metrics[metric_name])
        p = compute_statistics(pde_metrics[metric_name])
        c = comparison_results[metric_name]
        summary_rows.append({
            "": metric_name,  # the JAX package writes the transposed frame with its index
            "baseline_mean": b["mean"],
            "baseline_std": b["std"],
            "pde_mean": p["mean"],
            "pde_std": p["std"],
            "improvement": c["improvement"],
            "t_pvalue": c["t_pvalue"],
            "wilcoxon_pvalue": c["wilcoxon_pvalue"],
            "significant": c["significant"],
        })
    summary_csv = save_rows_to_csv(summary_rows, output_dir / f"evaluation_summary_{timestamp}.csv")
    print(f"Summary statistics saved to: {summary_csv}")

    comparison_json = output_dir / f"statistical_comparison_{timestamp}.json"
    with open(comparison_json, "w") as f:
        json.dump(make_json_serializable(comparison_results), f, indent=2)
    print(f"Statistical comparison saved to: {comparison_json}")

    return {
        "baseline_metrics": baseline_metrics,
        "pde_metrics": pde_metrics,
        "comparison_results": comparison_results,
        "results_csv": results_csv,
        "summary_csv": summary_csv,
        "comparison_json": comparison_json,
    }


def run_repeated_evaluations(
    baseline_model_paths: List,
    pde_model_paths: List,
    test_dir,
    test_json,
    batch_size: int = 8,
    threshold: float = 0.5,
    output_dir=None,
    test_data: Optional[DeviceDataset] = None,
    base_channels: int = 64,
    precision: Optional[str] = None,
    device=None,
    dtype: Optional[str] = None,
) -> Dict:
    """Pool the per-image metrics of N seed-paired checkpoint pairs, compare
    the pools and write ``aggregated_results_{ts}.csv`` (metric, model,
    mean, std, count); ``precision`` as in :func:`evaluate_and_compare`."""
    precision = _precision(precision, dtype)
    device = resolve_device(device)
    output_dir = Path(output_dir) if output_dir is not None else Path.cwd() / "output"
    output_dir.mkdir(parents=True, exist_ok=True)

    print("=" * 70)
    print("REPEATED EXPERIMENTS EVALUATION")
    print("=" * 70)
    print(f"Number of runs: {len(baseline_model_paths)}")

    test_data = (load_device_dataset(test_dir, test_json, device) if test_data is None
                 else test_data.to(device))

    all_baseline = {k: [] for k in _METRIC_KEYS}
    all_pde = {k: [] for k in _METRIC_KEYS}
    model = None
    for run_idx, (b_path, p_path) in enumerate(zip(baseline_model_paths, pde_model_paths)):
        print(f"\n{'=' * 70}\nRun {run_idx + 1}/{len(baseline_model_paths)}\n{'=' * 70}")
        for path, pooled in ((b_path, all_baseline), (p_path, all_pde)):
            model, _ = load_unet_params(path, model, base_channels, precision, device)
            metrics = evaluate_model(model, test_data, batch_size, threshold=threshold,
                                     precision=precision)
            for k in _METRIC_KEYS:
                pooled[k].extend(metrics[k])

    all_baseline = {k: np.asarray(v) for k, v in all_baseline.items()}
    all_pde = {k: np.asarray(v) for k, v in all_pde.items()}

    print("\n" + "=" * 70)
    print("AGGREGATED RESULTS (All Runs Combined)")
    print("=" * 70)
    print(format_metric_report(all_baseline, "Baseline (All Runs)"))
    print(format_metric_report(all_pde, "PDE-Constrained (All Runs)"))

    comparison_results = compare_models_statistically(all_baseline, all_pde, alpha=0.05)
    print("\n" + "=" * 70)
    print("STATISTICAL COMPARISON (Aggregated)")
    print("=" * 70)
    for metric_name, r in comparison_results.items():
        print(f"\n{metric_name.replace('_', ' ').title()}:")
        print(f"  Baseline: {r['baseline_mean']:.4f} ± {r.get('baseline_std', 0):.4f}")
        print(f"  PDE:      {r['pde_mean']:.4f} ± {r.get('pde_std', 0):.4f}")
        print(f"  Improvement: {r['improvement']:+.4f}")
        print(f"  Significant: {'Yes' if r['significant'] else 'No'} (p={r['t_pvalue']:.4f})")

    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    rows = []
    for metric_name in _METRIC_KEYS:
        for label, metrics in (("baseline", all_baseline), ("pde", all_pde)):
            s = compute_statistics(metrics[metric_name])
            rows.append({"metric": metric_name, "model": label, "mean": s["mean"],
                         "std": s["std"], "count": s["count"]})
    aggregated_csv = save_rows_to_csv(rows, output_dir / f"aggregated_results_{timestamp}.csv")
    print(f"\nAggregated results saved to: {aggregated_csv}")

    return {
        "baseline_metrics": all_baseline,
        "pde_metrics": all_pde,
        "comparison_results": comparison_results,
        "aggregated_csv": aggregated_csv,
    }
