"""Ablation engine: the variant runner and the study orchestration.

Counterpart of ``physics_informed_image_segmentation_tpu/experiments/ablation.py``,
with the same observable behaviour and file names (``.pth`` where the JAX
package writes ``.msgpack``):

* ``AblationConfig``: the 19 fields of a variant.
* ``run_ablation_variant``: Stage I baseline (when two-stage with PDE, or
  three-stage), Stage II with PDE (or a single stage), and the optional
  Stage III "baseline continuation" control, which reloads the Stage I
  weights and trains with Dice+BCE for exactly the epochs Stage II ran,
  without early stopping.  Every stage model is evaluated on both the
  in-distribution and the out-of-distribution test set, stage pairs are
  compared statistically, and the per-variant CSVs and results JSON are
  written.
* ``run_ablation_study``: runs the variants into
  ``{output_dir}/{name}_{timestamp}/``, aggregates, and writes the results
  JSON and three summary CSVs; ``resume_from`` continues a crashed study.

Kept from the JAX package, where it differs from ``train()``:
  * Stage II starts a fresh AdamW at the FULL learning rate (``train()``
    uses 0.1×);
  * three-stage variants default to 50 Stage I epochs;
  * the aggregated std is 0.0 (one run per variant).

Datasets are decoded once per study and stay on the device.  Stage II of a
physics variant runs its physics sums through the CUDA kernel on the GPU
(``train/objective.py``).  The model is built through the module-level
name ``UNet``.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import DeviceDataset, fold_seed, subset_fraction_indices
from ..models import UNet
from ..ops.stats import compare_models_statistically
from ..train.checkpoint import load_params, save_params
from ..train.csvlog import save_rows_to_csv
from ..train.engine import (
    EarlyStopping,
    create_train_state,
    make_eval_epoch_fn,
    make_train_epoch_fn,
    train_stage,
)
from ..train.evaluation import evaluate_model
from ..train.loop import load_device_dataset
from ..train.objective import LossConfig
from ..utils.device import resolve_device, set_precision

__all__ = [
    "AblationConfig",
    "create_ablation_loss_config",
    "run_ablation_variant",
    "run_ablation_study",
]

_METRIC_KEYS = ["dice_scores", "iou_scores", "boundary_f1_scores", "hausdorff_distances"]


@dataclass
class AblationConfig:
    """Configuration of one ablation variant."""

    name: str
    description: str
    use_pde: bool = False
    pde_weight: float = 1e-4
    phase_field_weight: float = 1e-4
    epsilon: float = 0.05
    diffusion_coeff: float = 5.0
    reaction_threshold: float = 0.5
    use_reaction_term: bool = True
    use_two_stage: bool = True
    use_three_stage: bool = False
    train_fraction: Optional[float] = None
    stage1_epochs: Optional[int] = None
    stage2_epochs: Optional[int] = None
    stage3_epochs: Optional[int] = None
    output_activation: str = "sigmoid"
    intermediate_activation: str = "relu"
    # parameter-init family: "lecun" (zero biases) or "torch" (torch's own
    # Conv2d/ConvTranspose2d reset), see models/unet.py
    param_init: str = "lecun"
    seed: int = 42

    def to_dict(self) -> Dict:
        return asdict(self)


def create_ablation_loss_config(
    config: AblationConfig, physics_backend: str = "auto"
) -> LossConfig:
    """Loss dispatch: plain Dice+BCE when the PDE is disabled; the
    diffusion-only residual when the reaction term is ablated; the full
    PDE loss otherwise.  ``physics_backend``: "auto", "cuda" or "torch"."""
    if not config.use_pde:
        return LossConfig(backend=physics_backend)
    if not config.use_reaction_term:
        return LossConfig(
            pde_weight=config.pde_weight,
            phase_field_weight=0.0,
            diffusion_coeff=config.diffusion_coeff,
            reaction_threshold=config.reaction_threshold,
            use_reaction_term=False,
            backend=physics_backend,
        )
    return LossConfig(
        pde_weight=config.pde_weight,
        phase_field_weight=config.phase_field_weight,
        diffusion_coeff=config.diffusion_coeff,
        reaction_threshold=config.reaction_threshold,
        epsilon=config.epsilon,
        backend=physics_backend,
    )


def _snake(name: str) -> str:
    return name.replace(" ", "_").lower()


def _np_dict(metrics: Dict[str, np.ndarray]) -> Dict[str, list]:
    return {k: np.asarray(v).tolist() for k, v in metrics.items()}


def _eval_both(model, in_dist: DeviceDataset, out_dist: DeviceDataset, batch_size: int,
               precision: str):
    """Per-image metrics on both test sets, in the study's precision."""
    return {
        "in_dist": evaluate_model(model, in_dist, batch_size, precision=precision),
        "out_dist": evaluate_model(model, out_dist, batch_size, precision=precision),
    }


def _improvement_pct(metric_name: str, v: dict) -> float:
    if v["baseline_mean"] is None or not v["baseline_mean"] > 0:
        return 0.0
    sign = -1.0 if metric_name == "hausdorff_distances" else 1.0
    return float(sign * v["improvement"] / v["baseline_mean"] * 100)


def _print_comparison(title: str, comparison: dict, label_a: str, label_b: str):
    print(f"\n{'=' * 70}\n{title}\n{'=' * 70}")
    print("\nStatistical Comparison Results (α = 0.05):")
    print("-" * 70)
    for metric_name, r in comparison.items():
        print(f"\n{metric_name.replace('_', ' ').title()}:")
        print(f"  {label_a} Mean: {r['baseline_mean']:.4f} ± {r['baseline_std']:.4f}")
        print(f"  {label_b} Mean: {r['pde_mean']:.4f} ± {r['pde_std']:.4f}")
        print(f"  Improvement:            {r['improvement']:+.4f}")
        print(f"  Paired t-test p-value:  {r['t_pvalue']:.4f}")
        print(f"  Wilcoxon p-value:       {r['wilcoxon_pvalue']:.4f}")
        print(f"  Statistically Significant: {'Yes' if r['significant'] else 'No'}")


def _comparison_csv(
    comparison: dict, csv_path: Path, a: str, b: str, with_pct: bool = False
):
    """Write a stage-pair comparison CSV: one row per metric with
    ``{a}_mean, {a}_std, {b}_mean, {b}_std, improvement[, improvement_pct],
    t_pvalue, wilcoxon_pvalue, significant``."""
    rows = []
    for metric_name, r in comparison.items():
        row = {
            "metric": metric_name,
            f"{a}_mean": r["baseline_mean"],
            f"{a}_std": r["baseline_std"],
            f"{b}_mean": r["pde_mean"],
            f"{b}_std": r["pde_std"],
            "improvement": r["improvement"],
        }
        if with_pct:
            row["improvement_pct"] = _improvement_pct(metric_name, r)
        row.update(
            t_pvalue=r["t_pvalue"],
            wilcoxon_pvalue=r["wilcoxon_pvalue"],
            significant=r["significant"],
        )
        rows.append(row)
    save_rows_to_csv(rows, csv_path)
    print(f"Comparison results saved to: {csv_path}")


def _compare_both(metrics_a: dict, metrics_b: dict) -> dict:
    return {
        "in_dist": compare_models_statistically(
            metrics_a["in_dist"], metrics_b["in_dist"], alpha=0.05
        ),
        "out_dist": compare_models_statistically(
            metrics_a["out_dist"], metrics_b["out_dist"], alpha=0.05
        ),
    }


def _comparison_json(comparison: dict, a: str, b: str, with_pct: bool) -> dict:
    out = {}
    for k, v in comparison.items():
        entry = {
            f"{a}_mean": float(v["baseline_mean"]),
            f"{a}_std": float(v["baseline_std"]),
            f"{b}_mean": float(v["pde_mean"]),
            f"{b}_std": float(v["pde_std"]),
            "improvement": float(v["improvement"]),
        }
        if with_pct:
            entry["improvement_pct"] = _improvement_pct(k, v)
        entry.update(
            t_pvalue=float(v["t_pvalue"]),
            wilcoxon_pvalue=float(v["wilcoxon_pvalue"]),
            significant=bool(v["significant"]),
        )
        out[k] = entry
    return out


def _persist_result(result: Dict, path: Path) -> Dict:
    """Write a variant's full results dict next to its artifacts.

    The per-variant ``{stem}_results.json`` is the unit of study resume:
    ``run_ablation_study(resume_from=...)`` reloads it instead of
    retraining the variant.  Written atomically (tmp + ``os.replace``), so
    a crash cannot leave a truncated file behind."""
    tmp = path.with_suffix(".json.tmp")
    with open(tmp, "w") as f:
        json.dump(result, f, indent=2)
    os.replace(tmp, path)
    return result


def run_ablation_variant(
    config: AblationConfig,
    *,
    datasets: Dict[str, DeviceDataset],
    batch_size: int = 8,
    learning_rate: float = 1e-4,
    stage1_epochs: int = 50,
    stage2_epochs: int = 50,
    early_stopping_patience: int = 10,
    ablation_folder: Path,
    precision: str = "bf16",
    physics_backend: str = "auto",
    base_channels: int = 64,
    device=None,
) -> Dict:
    """Run one ablation variant and return (and persist) its results dict.

    ``datasets``: ``train``, ``val``, ``in_dist`` and ``out_dist``
    (a :class:`DeviceDataset` each), moved to ``device``, which is CUDA
    unless ``"cpu"``.  The stages' shuffles draw from
    ``fold_seed(config.seed, stage)`` (stages 1, 2, 3) and the init from
    ``fold_seed(config.seed, 0)``; a ``train_fraction`` subset is drawn
    from the global NumPy RNG after ``np.random.seed(config.seed)``.
    """
    device = resolve_device(device)
    precision = set_precision(precision)
    ablation_folder = Path(ablation_folder)
    ablation_folder.mkdir(parents=True, exist_ok=True)
    stem = _snake(config.name)

    print(f"\n{'=' * 70}")
    print(f"ABLATION VARIANT: {config.name}")
    print(f"{'=' * 70}")
    print(f"Description: {config.description}")
    print(f"Configuration: {config.to_dict()}")

    np.random.seed(config.seed)
    train_data, val_data, in_dist, out_dist = (
        datasets[k].to(device) for k in ("train", "val", "in_dist", "out_dist"))
    if config.train_fraction is not None:
        train_data = train_data.select(
            subset_fraction_indices(train_data.n, config.train_fraction)
        )

    model = UNet(
        in_channels=1,
        out_channels=1,
        base_channels=base_channels,
        output_activation=config.output_activation,
        intermediate_activation=config.intermediate_activation,
        param_init=config.param_init,
        generator=torch.Generator().manual_seed(fold_seed(config.seed, 0)),
    ).to(device)

    dicebce = LossConfig(backend=physics_backend)
    baseline_test_metrics = None
    pde_test_metrics = None
    comparison_results = None
    baseline_model_path = None
    pde_model_path = None
    actual_stage2_epochs = None

    def run_stage(loss_cfg, num_epochs, stage_name, stage, csv_name, early_stopping=True):
        """One stage with a fresh AdamW at the full learning rate; returns
        its epoch rows."""
        state = create_train_state(model, learning_rate, dropout_seed=config.seed + stage)
        _, _, _, rows = train_stage(
            state,
            make_train_epoch_fn(loss_cfg, precision=precision),
            make_eval_epoch_fn(loss_cfg, precision=precision),
            train_data,
            val_data,
            batch_size=batch_size,
            num_epochs=num_epochs,
            stage_name=stage_name,
            shuffle_seed=fold_seed(config.seed, stage),
            early_stopping=(EarlyStopping(early_stopping_patience, 1e-4, "max")
                            if early_stopping else None),
            verbose=False,
            csv_path=ablation_folder / f"{stem}_{csv_name}_metrics.csv",
        )
        return rows

    run_stage1 = (config.use_two_stage and config.use_pde) or config.use_three_stage

    # ------------------------------------------------------------- Stage I
    if run_stage1:
        print("\nStage I: Baseline Training")
        if config.stage1_epochs is not None:
            s1_epochs = config.stage1_epochs
        elif config.use_three_stage:
            s1_epochs = 50  # the default of three-stage variants
        else:
            s1_epochs = stage1_epochs
        run_stage(dicebce, s1_epochs, "Stage I", 1, "stage1")
        baseline_model_path = save_params(
            model, ablation_folder / f"{stem}_baseline_after_stage1.pth"
        )
        print(f"Saved baseline model (after Stage I) to: {baseline_model_path}")
        print("\nEvaluating baseline model (Stage I) on test sets...")
        baseline_test_metrics = _eval_both(model, in_dist, out_dist, batch_size, precision)
        print("Baseline model evaluation complete.")

    # ------------------------------------------------------------ Stage II
    if config.use_pde or not config.use_two_stage or config.use_three_stage:
        stage_name = "Stage II (PDE)" if config.use_two_stage else "Training"
        print(f"\n{stage_name}: "
              f"{'PDE-Constrained' if config.use_pde else 'Baseline'} Training")
        loss_cfg = create_ablation_loss_config(config, physics_backend)
        if config.use_two_stage:
            s2_epochs = (
                config.stage2_epochs if config.stage2_epochs is not None else stage2_epochs
            )
        else:
            s2_epochs = stage1_epochs
        stage2_all_metrics = run_stage(loss_cfg, s2_epochs, stage_name, 2, "stage2")
        actual_stage2_epochs = len(stage2_all_metrics) if stage2_all_metrics else s2_epochs
        if config.use_three_stage:
            print(
                f"Stage II completed: {actual_stage2_epochs} epochs "
                f"(out of {s2_epochs} max)"
            )

        if config.use_pde and (config.use_three_stage or config.use_two_stage):
            pde_model_path = save_params(
                model, ablation_folder / f"{stem}_after_pde_stage2.pth"
            )
            print(f"Saved PDE model (after Stage II) to: {pde_model_path}")
            print("\nEvaluating PDE model (Stage II) on test sets...")
            pde_test_metrics = _eval_both(model, in_dist, out_dist, batch_size, precision)
            print("PDE model evaluation complete.")

        # two-stage + PDE (not three-stage): S1-vs-S2 comparison
        if config.use_two_stage and config.use_pde and not config.use_three_stage:
            comparison_results = _compare_both(baseline_test_metrics, pde_test_metrics)
            _print_comparison(
                f"COMPARING STAGE 1 vs STAGE 2 FOR {config.name} - IN-DISTRIBUTION",
                comparison_results["in_dist"], "Stage 1 (Baseline)", "Stage 2 (PDE)",
            )
            _print_comparison(
                f"COMPARING STAGE 1 vs STAGE 2 FOR {config.name} - OUT-OF-DISTRIBUTION",
                comparison_results["out_dist"], "Stage 1 (Baseline)", "Stage 2 (PDE)",
            )
            for dist in ("in_dist", "out_dist"):
                _comparison_csv(
                    comparison_results[dist],
                    ablation_folder / f"{stem}_stage1_vs_stage2_comparison_{dist}.csv",
                    "stage1", "stage2",
                )

    # ----------------------------------------------------------- Stage III
    if config.use_three_stage:
        print("\nStage III: Baseline Continuation Training")
        print("Loading baseline model from after Stage I (before PDE optimization)")
        if baseline_model_path is None or not Path(baseline_model_path).exists():
            raise FileNotFoundError(f"Baseline model not found: {baseline_model_path}")
        load_params(baseline_model_path, model)
        if actual_stage2_epochs is None:
            raise ValueError(
                "actual_stage2_epochs not set - Stage II must run before Stage III"
            )
        print(f"Stage III will train for {actual_stage2_epochs} epochs (same as Stage II)")
        run_stage(dicebce, actual_stage2_epochs, "Stage III (Baseline)", 3, "stage3",
                  early_stopping=False)
        print("\nEvaluating Stage III (baseline continuation) model on test sets...")
        stage3_metrics = _eval_both(model, in_dist, out_dist, batch_size, precision)

        s2_vs_s1 = _compare_both(baseline_test_metrics, pde_test_metrics)
        s3_vs_s1 = _compare_both(baseline_test_metrics, stage3_metrics)
        comparison_results = _compare_both(pde_test_metrics, stage3_metrics)
        for dist in ("in_dist", "out_dist"):
            loc = dist.replace("_", "-").upper()
            _print_comparison(
                f"COMPARING STAGE II (PDE) vs STAGE I (BASELINE) FOR {config.name} - {loc}",
                s2_vs_s1[dist], "Stage I (Baseline)", "Stage II (PDE)",
            )
            _print_comparison(
                f"COMPARING STAGE III (BASELINE CONTINUATION) vs STAGE I (BASELINE) "
                f"FOR {config.name} - {loc}",
                s3_vs_s1[dist], "Stage I (Baseline)", "Stage III (Baseline Cont.)",
            )
            _print_comparison(
                f"COMPARING STAGE II (PDE) vs STAGE III (BASELINE) FOR {config.name} - {loc}",
                comparison_results[dist], "Stage II (PDE)", "Stage III (Baseline)",
            )
            _comparison_csv(
                s2_vs_s1[dist],
                ablation_folder / f"{stem}_stage1_vs_stage2_comparison_{dist}.csv",
                "stage1", "stage2", with_pct=True,
            )
            _comparison_csv(
                s3_vs_s1[dist],
                ablation_folder / f"{stem}_stage1_vs_stage3_comparison_{dist}.csv",
                "stage1", "stage3", with_pct=True,
            )
            _comparison_csv(
                comparison_results[dist],
                ablation_folder / f"{stem}_stage2_vs_stage3_comparison_{dist}.csv",
                "stage2", "stage3",
            )

        model_path = save_params(model, ablation_folder / f"{stem}_after_stage3.pth")
        print(f"Saved final model (after Stage III) to: {model_path}")
        return _persist_result({
            "config": config.to_dict(),
            "model_path": str(model_path),
            "pde_model_path": str(pde_model_path) if pde_model_path else None,
            "baseline_model_path": str(baseline_model_path),
            "baseline_in_dist_metrics": _np_dict(baseline_test_metrics["in_dist"]),
            "baseline_out_dist_metrics": _np_dict(baseline_test_metrics["out_dist"]),
            "pde_in_dist_metrics": _np_dict(pde_test_metrics["in_dist"]),
            "pde_out_dist_metrics": _np_dict(pde_test_metrics["out_dist"]),
            "stage3_in_dist_metrics": _np_dict(stage3_metrics["in_dist"]),
            "stage3_out_dist_metrics": _np_dict(stage3_metrics["out_dist"]),
            "metrics": _np_dict(stage3_metrics["in_dist"]),
            "in_dist_metrics": _np_dict(stage3_metrics["in_dist"]),
            "out_dist_metrics": _np_dict(stage3_metrics["out_dist"]),
            "stage_comparison": {
                "stage1_vs_stage2": {
                    d: _comparison_json(s2_vs_s1[d], "stage1", "stage2", True)
                    for d in ("in_dist", "out_dist")
                },
                "stage1_vs_stage3": {
                    d: _comparison_json(s3_vs_s1[d], "stage1", "stage3", True)
                    for d in ("in_dist", "out_dist")
                },
                "stage2_vs_stage3": {
                    d: _comparison_json(comparison_results[d], "stage2", "stage3", False)
                    for d in ("in_dist", "out_dist")
                },
            },
        }, ablation_folder / f"{stem}_results.json")

    # ------------------------------------------ single-stage return path
    if not (config.use_two_stage and config.use_pde):
        model_path = save_params(model, ablation_folder / f"{stem}_{config.seed}.pth")
        print(f"Model saved to: {model_path}")
        print("\nEvaluating on test sets...")
        test_metrics = _eval_both(model, in_dist, out_dist, batch_size, precision)
        return _persist_result({
            "config": config.to_dict(),
            "model_path": str(model_path),
            "in_dist_metrics": _np_dict(test_metrics["in_dist"]),
            "out_dist_metrics": _np_dict(test_metrics["out_dist"]),
            "metrics": _np_dict(test_metrics["in_dist"]),
        }, ablation_folder / f"{stem}_results.json")

    # ------------------------------------- two-stage + PDE return path
    if baseline_test_metrics is None or pde_test_metrics is None or comparison_results is None:
        raise ValueError(
            f"Stage comparison variables not set for {config.name}. "
            "This should only happen for two-stage with PDE configurations."
        )
    return _persist_result({
        "config": config.to_dict(),
        "model_path": str(pde_model_path),
        "baseline_model_path": str(baseline_model_path),
        "pde_model_path": str(pde_model_path),
        "baseline_in_dist_metrics": _np_dict(baseline_test_metrics["in_dist"]),
        "baseline_out_dist_metrics": _np_dict(baseline_test_metrics["out_dist"]),
        "pde_in_dist_metrics": _np_dict(pde_test_metrics["in_dist"]),
        "pde_out_dist_metrics": _np_dict(pde_test_metrics["out_dist"]),
        "metrics": _np_dict(pde_test_metrics["in_dist"]),
        "in_dist_metrics": _np_dict(pde_test_metrics["in_dist"]),
        "out_dist_metrics": _np_dict(pde_test_metrics["out_dist"]),
        "stage_comparison": {
            d: {
                k: {
                    "baseline_mean": float(v["baseline_mean"]),
                    "baseline_std": float(v["baseline_std"]),
                    "pde_mean": float(v["pde_mean"]),
                    "pde_std": float(v["pde_std"]),
                    "improvement": float(v["improvement"]),
                    "t_pvalue": float(v["t_pvalue"]),
                    "wilcoxon_pvalue": float(v["wilcoxon_pvalue"]),
                    "significant": bool(v["significant"]),
                }
                for k, v in comparison_results[d].items()
            }
            for d in ("in_dist", "out_dist")
        },
    }, ablation_folder / f"{stem}_results.json")


def _write_study_files(folder: Path, ablation_name: str, timestamp: str, variants,
                       all_results: list, **extra):
    """A study's own files: the results JSON (``extra`` keys after its name)
    and the summary CSVs (in-distribution, out-of-distribution, and the
    legacy one of the in-distribution results), from the per-image metrics
    of each variant's results.  Returns the JSON's path, the CSVs' paths by
    suffix, and the in- and out-of-distribution aggregates."""
    aggregated_in, aggregated_out = {}, {}
    for variant in variants:
        runs = [r for r in all_results if r["config"]["name"] == variant.name]
        for agg, key in ((aggregated_in, "in_dist_metrics"), (aggregated_out, "out_dist_metrics")):
            values: Dict[str, list] = {m: [] for m in _METRIC_KEYS}
            for run in runs:
                if key in run:
                    for m in _METRIC_KEYS:
                        values[m].extend(run[key].get(m, []))
            agg[variant.name] = {
                m: {
                    "mean": float(np.nanmean(np.asarray(v, dtype=np.float64))),
                    "std": 0.0,  # one run per variant
                    "count": len(v),
                    "values": list(v),
                }
                for m, v in values.items()
                if v
            }

    results_json = folder / f"ablation_{ablation_name}_{timestamp}.json"
    with open(results_json, "w") as f:
        json.dump(
            {
                "ablation_name": ablation_name,
                **extra,
                "variants": [v.to_dict() for v in variants],
                "num_runs": 1,
                "results": all_results,
                "aggregated_results": aggregated_in,  # the legacy key
                "aggregated_results_in_dist": aggregated_in,
                "aggregated_results_out_dist": aggregated_out,
            },
            f,
            indent=2,
        )

    summaries = {}
    for suffix, agg in (("_in_dist", aggregated_in), ("_out_dist", aggregated_out),
                        ("", aggregated_in)):
        rows = [
            {"variant": vn, "metric": m, "mean": s["mean"], "std": s["std"],
             "count": s["count"]}
            for vn, metrics in agg.items()
            for m, s in metrics.items()
        ]
        path = folder / f"ablation_{ablation_name}_{timestamp}_summary{suffix}.csv"
        summaries[suffix] = save_rows_to_csv(rows, path)
    return results_json, summaries, aggregated_in, aggregated_out


def run_ablation_study(
    ablation_name: str,
    variants: List[AblationConfig],
    *,
    train_dir=None,
    train_json=None,
    val_dir=None,
    val_json=None,
    in_dist_test_dir=None,
    in_dist_test_json=None,
    out_dist_test_dir=None,
    out_dist_test_json=None,
    datasets: Optional[Dict[str, DeviceDataset]] = None,
    batch_size: int = 8,
    learning_rate: float = 1e-4,
    stage1_epochs: int = 50,
    stage2_epochs: int = 50,
    early_stopping_patience: int = 10,
    output_dir=None,
    precision: str = "bf16",
    physics_backend: str = "auto",
    base_channels: int = 64,
    resume_from=None,
    device=None,
) -> Dict:
    """Run a complete study on ``device`` (CUDA unless ``"cpu"``).

    Datasets are given as directories and JSONs (decoded once here, onto
    the device) or ready-made as ``datasets={'train','val','in_dist',
    'out_dist'}``.

    ``resume_from``: the ``{name}_{timestamp}`` folder of an interrupted
    study.  Variants whose ``{stem}_results.json`` is there are loaded
    instead of retrained (a corrupt one is retrained); the missing ones
    run into the same folder, and the aggregate and summary files are
    rewritten over the whole set.
    """
    device = resolve_device(device)
    results_root = (
        Path(output_dir) if output_dir is not None else Path.cwd() / "output" / "ablation"
    )
    results_root.mkdir(parents=True, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    if resume_from is not None:
        ablation_folder = Path(resume_from)
        if not ablation_folder.is_dir():
            raise FileNotFoundError(f"resume_from folder not found: {ablation_folder}")
        prefix = f"{ablation_name}_"
        if ablation_folder.name.startswith(prefix):
            # keep the interrupted run's timestamp in artifact names
            timestamp = ablation_folder.name[len(prefix):]
    else:
        ablation_folder = results_root / f"{ablation_name}_{timestamp}"
    ablation_folder.mkdir(parents=True, exist_ok=True)

    print("=" * 70)
    print(f"ABLATION STUDY: {ablation_name}")
    print("=" * 70)
    print(f"Output folder: {ablation_folder}")
    print(f"Number of variants: {len(variants)}")

    if datasets is None:
        datasets = {
            "train": load_device_dataset(train_dir, train_json, device),
            "val": load_device_dataset(val_dir, val_json, device),
            "in_dist": load_device_dataset(in_dist_test_dir, in_dist_test_json, device),
            "out_dist": load_device_dataset(out_dist_test_dir, out_dist_test_json, device),
        }
    else:
        datasets = {k: d.to(device) for k, d in datasets.items()}

    all_results = []
    for variant in variants:
        done_json = ablation_folder / f"{_snake(variant.name)}_results.json"
        if resume_from is not None and done_json.exists():
            try:
                with open(done_json) as f:
                    all_results.append(json.load(f))
            except json.JSONDecodeError:
                print(f"\n[resume] variant '{variant.name}': {done_json.name} "
                      "is corrupt (interrupted write?) — retraining")
            else:
                print(f"\n[resume] variant '{variant.name}': loaded completed "
                      f"results from {done_json.name} — skipping retrain")
                continue
        all_results.append(
            run_ablation_variant(
                variant,
                datasets=datasets,
                batch_size=batch_size,
                learning_rate=learning_rate,
                stage1_epochs=stage1_epochs,
                stage2_epochs=stage2_epochs,
                early_stopping_patience=early_stopping_patience,
                ablation_folder=ablation_folder,
                precision=precision,
                physics_backend=physics_backend,
                base_channels=base_channels,
                device=device,
            )
        )

    results_json, summaries, aggregated_in, aggregated_out = _write_study_files(
        ablation_folder, ablation_name, timestamp, variants, all_results)

    print(f"\n{'=' * 70}\nABLATION STUDY COMPLETE\n{'=' * 70}")
    print(f"All files saved to: {ablation_folder}")
    for title, agg in (
        ("In-Distribution", aggregated_in),
        ("Out-of-Distribution", aggregated_out),
    ):
        print(f"\nSummary Statistics - {title}:")
        print("-" * 70)
        for vn, metrics in agg.items():
            print(f"\n{vn}:")
            for m, s in metrics.items():
                print(f"  {m}: {s['mean']:.4f}")

    return {
        "ablation_name": ablation_name,
        "results_json": str(results_json),
        "summary_csv": str(summaries[""]),
        "summary_csv_in_dist": str(summaries["_in_dist"]),
        "summary_csv_out_dist": str(summaries["_out_dist"]),
        "aggregated_results": aggregated_in,
        "ablation_folder": str(ablation_folder),
    }
