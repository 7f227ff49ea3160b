"""Two-stage training orchestration (the ``train()`` entry point).

Counterpart of ``physics_informed_image_segmentation_tpu/train/loop.py``:

* Stage I:  Dice+BCE baseline, AdamW(lr, wd=1e-5), early stopping on
  val Dice (patience, min_delta=1e-4, mode=max).
* Stage II: Dice+BCE+λ_RD·PDE+λ_PF·phase-field fine-tuning with a
  fresh AdamW at 0.1×lr; its physics terms run through the fused CUDA
  kernel on the GPU.
* Or single-stage PDE-from-the-start.
* Saves ``unet_baseline.pth`` / ``unet_pde_regularized.pth`` (reference
  ``state_dict`` keys), per-epoch 17-column CSVs, the test-set evaluation
  (CSV + JSON) and, optionally, training plots.
* Optionally writes full train-state checkpoints and resumes an
  interrupted run from them.
"""

from __future__ import annotations

import time
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data import CocoSegmentationSource, DeviceDataset, fold_seed, subset_fraction_indices
from ..data.pipeline import num_batches
from ..models import build_model, count_parameters
from ..utils.device import resolve_device, set_precision
from .checkpoint import latest_checkpoint_step, load_params, restore_train_state, save_params
from .csvlog import save_test_metrics
from .engine import (
    EarlyStopping,
    create_train_state,
    make_eval_epoch_fn,
    make_train_epoch_fn,
    train_stage,
)
from .evaluation import evaluate_on_dataset
from .objective import LossConfig

__all__ = ["train", "load_device_dataset"]


def load_device_dataset(image_dir, annotation_file, device, image_size=(128, 128)) -> DeviceDataset:
    src = CocoSegmentationSource(Path(image_dir), Path(annotation_file), image_size)
    return DeviceDataset.from_numpy(src.images, src.masks, device)


def _read_metric_rows(csv_path: Path) -> list[dict]:
    """Load per-epoch rows from a 17-column stage CSV (resume replay).

    The stage CSV is rewritten every epoch, so a crash mid-write can leave
    a truncated final line; such a row (missing fields or unparseable
    numbers) and anything after it are dropped.
    """
    import csv

    rows: list[dict] = []
    with open(csv_path, newline="") as f:
        for r in csv.DictReader(f):
            try:
                row = {k: (int(v) if k == "epoch" else float(v)) for k, v in r.items()}
            except (TypeError, ValueError):
                break  # truncated trailing row from an interrupted rewrite
            rows.append(row)
    return rows


def _rows_cover_stage(rows: list[dict], num_epochs: int, patience: int) -> bool:
    """Whether a stage CSV proves its stage ran to completion: all
    ``num_epochs`` rows are present, or early stopping (with the live
    loop's parameters) fires within them.  Guards against a stale final
    artifact of an older run beside a newer, partial CSV."""
    if len(rows) >= num_epochs:
        return True
    probe = EarlyStopping(patience, 1e-4, "max")
    return any(probe(float(r["val_dice_score"]), int(r["epoch"])) for r in rows)


def _stage_resume(
    state,
    *,
    output_dir: Path,
    csv_glob: str,
    checkpoint_dir: Optional[Path],
    final_artifact: Optional[Path],
    steps_per_epoch: int,
    num_epochs: int,
    patience: int,
    verbose: bool,
    min_mtime: Optional[float] = None,
):
    """Resume plan for one stage: ``(state, initial_metrics, csv_path)``.

    In order: (1) the stage's final artifact exists and the CSV shows the
    stage complete: load the artifact into the model and replay every row
    (the stage then runs no epoch); (2) a train-state checkpoint exists:
    restore it and replay the rows up to its epoch (later epochs re-run
    and reproduce); (3) nothing to resume: ``(state, None, None)``.

    A final artifact beside a partial CSV is a stale leftover of an older
    run and is ignored.  The newest ``csv_glob`` file under ``output_dir``
    is the interrupted run's log, and resume continues it in place; a log
    older than ``min_mtime`` belongs to an earlier run and is ignored.
    """
    csvs = sorted(output_dir.glob(csv_glob), key=lambda p: p.stat().st_mtime)
    if not csvs:
        return state, None, None
    prev_csv = csvs[-1]
    if min_mtime is not None and prev_csv.stat().st_mtime < min_mtime:
        # Stage II starts after Stage I ends, so a Stage II log older than
        # the Stage I log being continued belongs to an earlier run.
        if verbose:
            print(f"[resume] ignoring {prev_csv.name}: older than this "
                  "run's previous stage — stale leftover from an earlier run")
        return state, None, None
    rows = _read_metric_rows(prev_csv)

    if final_artifact is not None and final_artifact.exists() and rows:
        if _rows_cover_stage(rows, num_epochs, patience):
            load_params(final_artifact, state.model)
            if verbose:
                print(f"[resume] stage already complete: {final_artifact.name} "
                      f"+ {prev_csv.name} ({len(rows)} epochs)")
            return state, rows, prev_csv
        if verbose:
            print(f"[resume] ignoring stale {final_artifact.name}: {prev_csv.name} covers "
                  f"only {len(rows)}/{num_epochs} epochs with no early stop")

    if checkpoint_dir is not None and latest_checkpoint_step(checkpoint_dir) is not None:
        state = restore_train_state(state, checkpoint_dir)
        done = state.step // steps_per_epoch
        if verbose:
            print(f"[resume] restored {checkpoint_dir.name} checkpoint at step "
                  f"{state.step} (= {done} epochs), log {prev_csv.name}")
        return state, rows[:done], prev_csv
    return state, None, None


def train(
    use_two_stage: bool = True,
    pde_weight: float = 1e-4,
    diffusion_coeff: float = 5.0,
    reaction_threshold: float = 0.5,
    phase_field_weight: float = 1e-4,
    epsilon: float = 0.05,
    batch_size: int = 8,
    learning_rate: float = 1e-4,
    stage1_epochs: int = 50,
    stage2_epochs: int = 50,
    early_stopping_patience: int = 10,
    train_fraction: Optional[float] = None,
    seed: int = 42,
    *,
    data_root: Optional[Path] = None,
    train_data: Optional[DeviceDataset] = None,
    val_data: Optional[DeviceDataset] = None,
    test_data: Optional[DeviceDataset] = None,
    output_dir: Optional[Path] = None,
    models_dir: Optional[Path] = None,
    precision: str = "bf16",
    physics_backend: str = "auto",
    make_plots: bool = True,
    verbose: bool = True,
    checkpoint_every: int = 0,
    checkpoint_keep: Optional[int] = 2,
    resume: bool = False,
    base_channels: int = 64,
    param_init: str = "lecun",
    device=None,
    model_name: str = "unet",
) -> dict:
    """Run the two-stage (or single-stage) pipeline; returns artifacts.

    Runs on CUDA unless ``device="cpu"``; without a card and without
    ``device="cpu"`` it raises.  Pass ``train_data``/``val_data``/
    ``test_data`` (moved to ``device``) to skip disk loading; otherwise
    the reference directory layout under ``data_root`` is read.
    ``precision="f32"`` turns TF32 off process-wide (see
    :func:`..utils.device.set_precision`).

    ``checkpoint_every`` > 0 writes full train-state checkpoints every N
    epochs (and at each stage's last) under
    ``{models_dir}/checkpoints/{stage1,stage2,single_stage}``;
    ``checkpoint_keep`` bounds retention to the newest N per stage
    (``None`` keeps all; a state is ~250 MB at base_channels 64).

    ``resume=True`` continues an interrupted run in the same
    ``output_dir``/``models_dir`` with the same arguments: a stage whose
    final ``.pth`` and CSV show it complete is skipped, a partial stage
    restarts from its latest checkpoint, completed epochs are replayed
    through the same best-epoch tracking and early stopping, and the
    interrupted run's CSV is continued in place.  Shuffles are seeded per
    epoch and the dropout generator's state is checkpointed, so a resumed
    run is bit-identical to an uninterrupted one on the same device.

    ``model_name``: a name of :data:`..models.MODELS`, built by
    :func:`..models.build_model` for the training images' side.
    """
    device = resolve_device(device)
    precision = set_precision(precision)
    # global NumPy seed: train_fraction subsetting draws from it
    np.random.seed(seed)

    base = Path(data_root) if data_root is not None else Path.cwd()
    output_dir = Path(output_dir) if output_dir is not None else base / "output"
    models_dir = Path(models_dir) if models_dir is not None else base / "models"
    output_dir.mkdir(parents=True, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")

    if verbose:
        print("=" * 70)
        print("PDE-CONSTRAINED CELL SEGMENTATION TRAINING (PyTorch)")
        print("=" * 70)
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
        print(f"Device: {device} ({name})")
        print("Training strategy: "
              + ("Two-stage" if use_two_stage else "Single-stage (PDE from start)"))

    # ------------------------------------------------------------------ data
    if train_data is None:
        img_dir = base / "images"
        ann_dir = img_dir / "annotation"
        if verbose:
            print("\nLoading datasets...")
        train_data = load_device_dataset(
            img_dir / "training", ann_dir / "training_annotation.json", device
        )
        val_data = load_device_dataset(
            img_dir / "validation", ann_dir / "validation_annotation.json", device
        )
        test_json = ann_dir / "testing_annotation.json"
        test_dir = img_dir / "testing"
        if test_dir.exists() and test_json.exists():
            test_data = load_device_dataset(test_dir, test_json, device)
    else:
        train_data, val_data = train_data.to(device), val_data.to(device)
        if test_data is not None:
            test_data = test_data.to(device)

    if train_fraction is not None:
        if verbose:
            print(f"Using {train_fraction * 100:.1f}% of training data "
                  f"({int(train_data.n * train_fraction)} samples)")
        train_data = train_data.select(subset_fraction_indices(train_data.n, train_fraction))

    fraction_str = f"_frac{train_fraction:.2f}" if train_fraction is not None else ""
    csv_path_stage1 = output_dir / f"metrics_stage1_{timestamp}{fraction_str}.csv"
    csv_path_stage2 = output_dir / f"metrics_stage2_{timestamp}{fraction_str}.csv"

    if verbose:
        print(f"Training samples: {train_data.n}")
        print(f"Validation samples: {val_data.n}")
        print(f"Batch size: {batch_size}")

    # ----------------------------------------------------------------- model
    def make_model(generator=None, init="lecun"):
        return build_model(model_name, image_size=train_data.images.shape[1],
                           base_channels=base_channels, param_init=init, generator=generator)

    model = make_model(torch.Generator().manual_seed(fold_seed(seed, 0)), param_init).to(device)
    if verbose:
        print(f"\nCreating {type(model).__name__} model... ({count_parameters(model):,} params)")

    results: dict = {"timestamp": timestamp}
    stage2_loss_cfg = LossConfig(
        pde_weight=pde_weight,
        phase_field_weight=phase_field_weight,
        diffusion_coeff=diffusion_coeff,
        reaction_threshold=reaction_threshold,
        epsilon=epsilon,
        backend=physics_backend,
    )
    stage1_loss_cfg = LossConfig(backend=physics_backend)

    steps_per_epoch = num_batches(train_data.n, batch_size)
    resumed_log_mtime: dict = {}  # a resumed stage's log, as the interrupted run left it

    def run_stage(cfg, lr, num_epochs, name, stream, csv_path, tag, final_artifact,
                  min_mtime=None):
        """One stage, resumed when asked; returns its results, the CSV it
        wrote and the number of epochs it trained."""
        state = create_train_state(model, lr, dropout_seed=seed + stream)
        ckpt_dir = models_dir / "checkpoints" / tag if checkpoint_every > 0 else None
        initial = None
        if resume:
            state, initial, prev_csv = _stage_resume(
                state, output_dir=output_dir, csv_glob=f"metrics_{tag}_*.csv",
                checkpoint_dir=ckpt_dir, final_artifact=final_artifact,
                steps_per_epoch=steps_per_epoch, num_epochs=num_epochs,
                patience=early_stopping_patience, verbose=verbose, min_mtime=min_mtime,
            )
            if prev_csv is not None:
                csv_path = prev_csv
                resumed_log_mtime[tag] = prev_csv.stat().st_mtime
        timing: dict = {}
        state, best, best_epoch, epochs = train_stage(
            state,
            make_train_epoch_fn(cfg, precision=precision),
            make_eval_epoch_fn(cfg, precision=precision),
            train_data,
            val_data,
            num_epochs=num_epochs,
            stage_name=name,
            shuffle_seed=fold_seed(seed, stream),
            early_stopping=EarlyStopping(early_stopping_patience, 1e-4, "max"),
            csv_path=csv_path,
            checkpoint_dir=ckpt_dir,
            checkpoint_every=checkpoint_every,
            checkpoint_keep=checkpoint_keep,
            initial_metrics=initial,
            timing_out=timing,
            batch_size=batch_size,
            verbose=verbose,
        )
        return best, best_epoch, epochs, timing, csv_path, len(epochs) - len(initial or [])

    n_images_trained = 0
    stage_timings: list[dict] = []
    t_start = time.perf_counter()

    if use_two_stage:
        if verbose:
            print("\n" + "=" * 70)
            print("STAGE I: BASELINE TRAINING (Unconstrained)")
            print("=" * 70)
            print("Objective: L = L_Dice + L_BCE")
        best1, best1_epoch, s1_metrics, t1, csv_path_stage1, n_new = run_stage(
            stage1_loss_cfg, learning_rate, stage1_epochs, "Stage I", 1, csv_path_stage1,
            "stage1", models_dir / "unet_baseline.pth",
        )
        n_images_trained += n_new * train_data.n
        stage_timings.append(t1)
        if verbose and best1:
            print(f"\nStage I complete. Best validation Dice: "
                  f"{best1['val']['dice_score']:.6f} at epoch {best1_epoch}")
        model_path_stage1 = save_params(model, models_dir / "unet_baseline.pth")
        if verbose:
            print(f"Stage I model saved to: {model_path_stage1}")
        results.update(
            stage1={"best": best1, "best_epoch": best1_epoch, "epochs": s1_metrics},
            baseline_model=model_path_stage1,
            stage1_csv=csv_path_stage1,
        )

        stage2_lr = learning_rate * 0.1
        if verbose:
            print("\n" + "=" * 70)
            print("STAGE II: PDE-CONSTRAINED FINE-TUNING")
            print("=" * 70)
            print("Objective: L = L_Dice + L_BCE + λ_RD * L_RD + λ_PF * L_PF")
            print(f"  λ_RD (reaction-diffusion): {pde_weight}")
            print(f"  λ_PF (phase-field): {phase_field_weight}")
            print(f"  Diffusion coefficient (D): {diffusion_coeff}")
            print(f"  Reaction threshold (a): {reaction_threshold}")
            if phase_field_weight > 0:
                print(f"  Phase-field epsilon (ε): {epsilon}")
            print(f"  Learning rate for Stage II: {stage2_lr:.2e} "
                  f"(reduced from {learning_rate:.2e})")
        # fresh AdamW over the Stage I weights
        best2, best2_epoch, s2_metrics, t2, csv_path_stage2, n_new = run_stage(
            stage2_loss_cfg, stage2_lr, stage2_epochs, "Stage II", 2, csv_path_stage2,
            "stage2", models_dir / "unet_pde_regularized.pth",
            # the Stage I log's time before this run touched it: replaying an
            # early stop rewrites that log
            min_mtime=resumed_log_mtime.get(
                "stage1",
                csv_path_stage1.stat().st_mtime if csv_path_stage1.exists() else None),
        )
        n_images_trained += n_new * train_data.n
        stage_timings.append(t2)
        if verbose and best2:
            print(f"\nStage II complete. Best validation Dice: "
                  f"{best2['val']['dice_score']:.6f} at epoch {best2_epoch}")
            print("\nStability checks:")
            print(f"  Final PDE loss: {best2['val']['pde_loss']:.6f}")
            print(f"  Final Dice loss: {best2['val']['dice_loss']:.6f}")
            print(f"  Final BCE loss: {best2['val']['bce_loss']:.6f}")
            if best1:
                delta = best2["val"]["dice_score"] - best1["val"]["dice_score"]
                print("\nPDE regularization effect:")
                print(f"  Dice score improvement: {delta:+.6f}")
        model_path_stage2 = save_params(model, models_dir / "unet_pde_regularized.pth")
        if verbose:
            print(f"Stage II model saved to: {model_path_stage2}")
        results.update(
            stage2={"best": best2, "best_epoch": best2_epoch, "epochs": s2_metrics},
            pde_model=model_path_stage2,
            stage2_csv=csv_path_stage2,
        )
        plot_csvs = (csv_path_stage1, csv_path_stage2)
    else:
        if verbose:
            print("\n" + "=" * 70)
            print("SINGLE-STAGE TRAINING (PDE from start)")
            print("=" * 70)
        csv_path_single = output_dir / f"metrics_single_stage_{timestamp}{fraction_str}.csv"
        best, best_epoch, s_metrics, t_single, csv_path_single, n_new = run_stage(
            stage2_loss_cfg, learning_rate, stage1_epochs, "Training", 1, csv_path_single,
            "single_stage", models_dir / "unet_pde_regularized.pth",
        )
        n_images_trained += n_new * train_data.n
        stage_timings.append(t_single)
        model_path_stage2 = save_params(model, models_dir / "unet_pde_regularized.pth")
        if verbose:
            print(f"Model saved to: {model_path_stage2}")
        results.update(
            single_stage={"best": best, "best_epoch": best_epoch, "epochs": s_metrics},
            pde_model=model_path_stage2,
            single_csv=csv_path_single,
        )
        plot_csvs = (csv_path_single, None)

    elapsed = time.perf_counter() - t_start
    results["images_per_sec"] = n_images_trained / elapsed if elapsed > 0 else 0.0
    steady = [t["steady_state_images_per_sec"] for t in stage_timings
              if t.get("steady_state_images_per_sec")]
    results["steady_state_images_per_sec"] = (
        sum(steady) / len(steady) if steady else results["images_per_sec"]
    )
    results["stage_timings"] = stage_timings
    if verbose:
        print(f"\nThroughput: {results['steady_state_images_per_sec']:.1f} train "
              "images/sec steady-state (first epoch of each stage excluded; "
              f"{n_images_trained} images in {elapsed:.1f}s wall incl. validation)")

    if make_plots:
        try:
            from ..utils.plot import plot_training_results

            print("\n" + "=" * 70)
            print("GENERATING TRAINING PLOTS")
            print("=" * 70)
            plot_training_results(plot_csvs[0], plot_csvs[1], output_dir, show_plots=False)
        except Exception as e:  # plotting must never kill a finished run
            print(f"Warning: plotting failed: {e}")

    # ============================================ TEST EVALUATION
    if test_data is not None:
        if verbose:
            print("\n" + "=" * 70)
            print("TEST SET EVALUATION")
            print("=" * 70)
        final_name = "PDE-Constrained (Stage II)" if use_two_stage else "Single-Stage PDE-Constrained"
        final_tag = "stage2" if use_two_stage else "single_stage"
        test_metrics = evaluate_on_dataset(
            model, test_data, batch_size, final_name, verbose, precision=precision
        )
        save_test_metrics(
            test_metrics, output_dir / f"test_metrics_{final_tag}_{timestamp}{fraction_str}",
            model_name=final_name,
        )
        if use_two_stage:
            stage1_model = load_params(results["baseline_model"], make_model()).to(device)
            stage1_metrics = evaluate_on_dataset(
                stage1_model, test_data, batch_size, "Baseline (Stage I)", verbose,
                precision=precision,
            )
            save_test_metrics(
                stage1_metrics,
                output_dir / f"test_metrics_stage1_{timestamp}{fraction_str}",
                model_name="Baseline (Stage I)",
            )
            results.update(test_metrics_stage2=test_metrics, test_metrics_stage1=stage1_metrics)
        else:
            results["test_metrics"] = test_metrics
    elif verbose:
        print("Warning: Test set not found — skipping test set evaluation.")

    if verbose:
        print("\n" + "=" * 70)
        print("TRAINING COMPLETE")
        print("=" * 70)
    results["model"] = model
    return results
