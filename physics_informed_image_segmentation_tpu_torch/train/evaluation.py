"""Model evaluation: per-image metric sweeps over a dataset.

Counterpart of ``physics_informed_image_segmentation_tpu/train/evaluation.py``.
Dice / IoU / Boundary-F1 run batched on the model's device; only the
Hausdorff distance runs on the host (SciPy), at evaluation time.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..data.pipeline import DeviceDataset, epoch_batch_indices
from ..ops import metrics as M
from ..ops.stats import format_metric_report
from .engine import forward_nhwc

__all__ = ["evaluate_model", "evaluate_on_dataset", "validate"]


@torch.no_grad()
def evaluate_model(
    model,
    data: DeviceDataset,
    batch_size: int = 8,
    threshold: float = 0.5,
    with_hausdorff: bool = True,
    precision: str = "f32",
) -> Dict[str, np.ndarray]:
    """Per-image metric arrays for a whole dataset: ``dice_scores``,
    ``iou_scores``, ``boundary_f1_scores`` and ``hausdorff_distances``
    (NaN where a boundary is empty)."""
    model.eval()
    idx, valid = epoch_batch_indices(data.n, batch_size, shuffle=False, device=data.device)
    dice, iou, bf1, pred_bin = [], [], [], []
    for b in range(idx.shape[0]):
        pred = forward_nhwc(model, data.images[idx[b]], precision)[..., 0]
        y = data.masks[idx[b]][..., 0]
        dice.append(M.dice_score_per_sample(pred, y, threshold=threshold))
        iou.append(M.iou_score_per_sample(pred, y, threshold=threshold))
        bf1.append(M.boundary_f1_per_sample(pred, y, threshold=threshold))
        pred_bin.append((pred > threshold).to(torch.float32))
    keep = valid.reshape(-1).cpu().numpy() > 0
    results = {
        "dice_scores": torch.cat(dice).cpu().numpy()[keep],
        "iou_scores": torch.cat(iou).cpu().numpy()[keep],
        "boundary_f1_scores": torch.cat(bf1).cpu().numpy()[keep],
    }
    if with_hausdorff:
        preds = torch.cat(pred_bin).cpu().numpy()[keep]
        masks = data.masks[..., 0].cpu().numpy()
        order = idx.reshape(-1).cpu().numpy()[keep]
        hausdorff = []
        for img_i, pb in zip(order, preds):
            h = M.hausdorff_distance_np(pb, masks[img_i])
            hausdorff.append(h if np.isfinite(h) else np.nan)
        results["hausdorff_distances"] = np.asarray(hausdorff)
    return results


def evaluate_on_dataset(
    model,
    data: DeviceDataset,
    batch_size: int = 8,
    model_name: str = "Model",
    verbose: bool = True,
    threshold: float = 0.5,
    precision: str = "f32",
) -> Dict[str, np.ndarray]:
    """Evaluate and print the mean ± std report."""
    if verbose:
        print(f"\nEvaluating {model_name} on test set...")
        print("=" * 70)
        print(f"Test samples: {data.n}")
    metrics = evaluate_model(
        model, data, batch_size=batch_size, threshold=threshold, precision=precision
    )
    if verbose:
        print(format_metric_report(metrics, model_name=model_name))
    return metrics


def validate(model, data: DeviceDataset, loss_cfg=None, batch_size: int = 8,
             precision: str = "f32") -> Dict[str, float]:
    """One validation pass: loss, dice_score (batch-mean of global Dice),
    loss components and per-sample iou/boundary-F1 means."""
    from .engine import make_eval_epoch_fn
    from .objective import LossConfig

    eval_fn = make_eval_epoch_fn(loss_cfg or LossConfig(), precision=precision)
    idx, valid = epoch_batch_indices(data.n, batch_size, shuffle=False, device=data.device)
    return eval_fn(model, data.images, data.masks, idx, valid)
