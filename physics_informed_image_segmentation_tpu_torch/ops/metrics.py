"""Segmentation quality metrics (PyTorch on the model's device; NumPy for
the host-side Hausdorff distance).

Counterpart of ``physics_informed_image_segmentation_tpu/ops/metrics.py``:

* global and per-sample thresholded Dice and IoU,
* Boundary-F1 with a pixel tolerance, computed on the device by
  morphology: boundary = mask ∧ ¬erode(mask, 3×3) with background
  padding, and the tolerance test by dilation with an exact Euclidean
  disk (offsets with dy² + dx² ≤ tol²),
* the symmetric Hausdorff distance between boundary point sets, on the
  host with SciPy, at evaluation time only.

The device functions take ``(..., H, W)`` probability/mask tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "dice_score",
    "dice_score_per_sample",
    "iou_score",
    "iou_score_per_sample",
    "overlap_sums",
    "dice_from_sums",
    "iou_from_sums",
    "extract_boundaries",
    "boundary_counts",
    "boundary_f1_from_counts",
    "boundary_f1_per_sample",
    "hausdorff_distance_np",
    "extract_boundaries_np",
    "THRESHOLD",
    "BOUNDARY_TOLERANCE",
]

_SMOOTH = 1e-6
THRESHOLD = 0.5
BOUNDARY_TOLERANCE = 2


def dice_score(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    threshold: float = 0.5,
    smooth: float = _SMOOTH,
    mask: Optional[torch.Tensor] = None,
    reduce=None,
) -> torch.Tensor:
    """Global thresholded Dice over the flattened batch.

    ``reduce``: for a batch sharded over ranks, a sum over the ranks
    applied to the three sums before the ratio is formed.
    """
    p = (predictions > threshold).to(predictions.dtype)
    if mask is not None:
        p = p * mask
        targets = targets * mask
    intersection = torch.sum(p * targets)
    if reduce is None:
        return (2.0 * intersection + smooth) / (torch.sum(p) + torch.sum(targets) + smooth)
    intersection, sp, st = reduce(torch.stack([intersection, torch.sum(p), torch.sum(targets)]))
    return (2.0 * intersection + smooth) / (sp + st + smooth)


def _flatten_per_sample(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def overlap_sums(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    threshold: float = 0.5,
) -> torch.Tensor:
    """Per-sample ``[Σp·t, Σp, Σt]`` of the thresholded prediction, shape
    ``(B, 3)``: what per-sample Dice and IoU are made of.  Sums of a
    sample's bands add up to the sample's sums."""
    p = _flatten_per_sample((predictions > threshold).to(predictions.dtype))
    t = _flatten_per_sample(targets)
    return torch.stack([torch.sum(p * t, dim=1), torch.sum(p, dim=1), torch.sum(t, dim=1)], 1)


def dice_from_sums(sums: torch.Tensor, smooth: float = _SMOOTH) -> torch.Tensor:
    """Per-sample Dice from :func:`overlap_sums`."""
    intersection, sp, st = sums.unbind(-1)
    return (2.0 * intersection + smooth) / (sp + st + smooth)


def iou_from_sums(sums: torch.Tensor, smooth: float = _SMOOTH) -> torch.Tensor:
    """Per-sample IoU from :func:`overlap_sums`."""
    intersection, sp, st = sums.unbind(-1)
    union = sp + st - intersection
    return (intersection + smooth) / (union + smooth)


def dice_score_per_sample(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    threshold: float = 0.5,
    smooth: float = _SMOOTH,
) -> torch.Tensor:
    """Per-sample thresholded Dice, shape ``(B,)``."""
    return dice_from_sums(overlap_sums(predictions, targets, threshold), smooth)


def iou_score(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    threshold: float = 0.5,
    smooth: float = _SMOOTH,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Global thresholded IoU."""
    p = (predictions > threshold).to(predictions.dtype)
    if mask is not None:
        p = p * mask
        targets = targets * mask
    intersection = torch.sum(p * targets)
    union = torch.sum(p) + torch.sum(targets) - intersection
    return (intersection + smooth) / (union + smooth)


def iou_score_per_sample(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    threshold: float = 0.5,
    smooth: float = _SMOOTH,
) -> torch.Tensor:
    """Per-sample IoU, shape ``(B,)``."""
    return iou_from_sums(overlap_sums(predictions, targets, threshold), smooth)


def _erode(mask: torch.Tensor) -> torch.Tensor:
    """3×3 binary erosion on the last two axes, outside = background (0)."""
    h, w = mask.shape[-2], mask.shape[-1]
    p = F.pad(mask, (1, 1, 1, 1), value=0.0)
    out = torch.ones_like(mask)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = torch.minimum(out, p[..., dy : dy + h, dx : dx + w])
    return out


def extract_boundaries(mask: torch.Tensor) -> torch.Tensor:
    """Boundary pixels of a binary mask: ``mask & ~erode(mask)``."""
    return mask * (1.0 - _erode(mask))


def _disk_offsets(tolerance: int) -> list[tuple[int, int]]:
    return [
        (dy, dx)
        for dy in range(-tolerance, tolerance + 1)
        for dx in range(-tolerance, tolerance + 1)
        if dy * dy + dx * dx <= tolerance * tolerance
    ]


def _dilate_disk(mask: torch.Tensor, tolerance: int) -> torch.Tensor:
    """Binary dilation with an exact Euclidean disk of radius ``tolerance``."""
    if tolerance <= 0:
        return mask
    h, w = mask.shape[-2], mask.shape[-1]
    tol = tolerance
    p = F.pad(mask, (tol, tol, tol, tol), value=0.0)
    out = torch.zeros_like(mask)
    for dy, dx in _disk_offsets(tol):
        out = torch.maximum(out, p[..., tol + dy : tol + dy + h, tol + dx : tol + dx + w])
    return out


def boundary_counts(
    pred_bin: torch.Tensor,
    targets: torch.Tensor,
    tolerance: int = BOUNDARY_TOLERANCE,
    halo: int = 0,
) -> torch.Tensor:
    """Per-sample Boundary-F1 counts ``[Σ pb·near(tb), Σ pb, Σ tb·near(pb),
    Σ tb]``, shape ``(B, 4)``, of a binary prediction and target (B, H, W);
    pb, tb are their boundaries and ``near`` the disk dilation by
    ``tolerance`` (``near(x) = x`` at tolerance 0).

    ``halo``: the first and last ``halo`` rows are another band's rows (or
    background at the image's edge): boundaries and dilations read them,
    the counts leave them out.  A band with ``tolerance + 1`` such rows on
    each side gives the counts of its own rows exactly, so the counts of a
    sample's bands add up to the sample's.
    """
    pred_b = extract_boundaries(pred_bin)
    target_b = extract_boundaries(targets)
    near_target = _dilate_disk(target_b, tolerance)
    near_pred = _dilate_disk(pred_b, tolerance)
    rows = slice(halo, pred_bin.shape[-2] - halo)
    dims = tuple(range(1, pred_bin.dim()))
    return torch.stack([
        torch.sum((pred_b * near_target)[..., rows, :], dim=dims),
        torch.sum(pred_b[..., rows, :], dim=dims),
        torch.sum((target_b * near_pred)[..., rows, :], dim=dims),
        torch.sum(target_b[..., rows, :], dim=dims),
    ], 1)


def boundary_f1_from_counts(counts: torch.Tensor, tolerance: int = BOUNDARY_TOLERANCE,
                            smooth: float = _SMOOTH) -> torch.Tensor:
    """Per-sample Boundary-F1 from :func:`boundary_counts`."""
    pn, p, tn, t = counts.unbind(-1)
    if tolerance > 0:
        precision = (pn + smooth) / (p + smooth)
        recall = (tn + smooth) / (t + smooth)
        return (2.0 * precision * recall + smooth) / (precision + recall + smooth)
    return (2.0 * pn + smooth) / (p + t + smooth)


def boundary_f1_per_sample(
    predictions: torch.Tensor,
    targets: torch.Tensor,
    threshold: float = THRESHOLD,
    tolerance: int = BOUNDARY_TOLERANCE,
    smooth: float = _SMOOTH,
) -> torch.Tensor:
    """Per-sample Boundary-F1 with pixel tolerance, shape ``(B,)``:
    precision is the share of predicted boundary pixels within
    ``tolerance`` of a target boundary pixel, recall vice versa, combined
    as ``(2PR + s) / (P + R + s)``."""
    pred_bin = (predictions > threshold).to(predictions.dtype)
    counts = boundary_counts(pred_bin, targets, tolerance)
    return boundary_f1_from_counts(counts, tolerance, smooth)


def extract_boundaries_np(mask: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`extract_boundaries` for host-side post-processing."""
    m = np.asarray(mask, dtype=np.float32)
    p = np.pad(m, 1, constant_values=0.0)
    eroded = np.ones_like(m)
    h, w = m.shape
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            eroded = np.minimum(eroded, p[dy : dy + h, dx : dx + w])
    return m * (1.0 - eroded)


def hausdorff_distance_np(pred_mask: np.ndarray, target_mask: np.ndarray) -> float:
    """Symmetric Hausdorff distance between boundary point sets (host-side,
    eval only); ``inf`` when either boundary is empty."""
    from scipy.spatial.distance import directed_hausdorff

    pred_b = extract_boundaries_np(pred_mask)
    target_b = extract_boundaries_np(target_mask)
    pred_coords = np.column_stack(np.where(pred_b > 0))
    target_coords = np.column_stack(np.where(target_b > 0))
    if len(pred_coords) == 0 or len(target_coords) == 0:
        return float("inf")
    return max(
        directed_hausdorff(pred_coords, target_coords)[0],
        directed_hausdorff(target_coords, pred_coords)[0],
    )
