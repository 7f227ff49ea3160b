"""The Stage II objective and the epoch metrics, plainly.

Written from the reference repository's ``src/loss.py``, ``src/pde.py`` and
``src/metrics.py``:

* soft Dice over the flattened batch, ``1 - (2 sum(p t) + s) / (sum p + sum t + s)``
  with s = 1e-6;
* binary cross-entropy on probabilities (``F.binary_cross_entropy``: logs
  clamped at -100);
* the reaction-diffusion residual ``r = D lap(u) + u (1 - u) (u - a)``
  with the 5-point Laplacian under mirror boundaries, penalised as
  ``mean(r^2)``;
* the phase-field energy ``mean(eps/2 |grad u|^2 + u^2 (1 - u)^2 / eps)``
  with central differences under mirror boundaries;
* ``L = 0.5 Dice + 0.5 BCE + lambda_RD mean(r^2) + lambda_PF phase-field``.

Metrics of masks thresholded at 0.5: Dice and IoU per sample and over a
batch, and Boundary-F1 with a 2-pixel tolerance: a boundary is a mask pixel
with a background pixel (or the outside) among its 3x3 neighbours, and a
boundary pixel counts as matched when one of the other mask's boundary
pixels lies within Euclidean distance 2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["objective", "batch_metrics"]

SMOOTH = 1e-6


def _mirror(u: torch.Tensor) -> torch.Tensor:
    return F.pad(u[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]


def objective(p: torch.Tensor, t: torch.Tensor, cfg: dict) -> tuple[torch.Tensor, dict]:
    """The loss of one batch of probability maps ``p`` and masks ``t``, (B, H, W),
    and its two physics terms, unweighted."""
    dice = 1.0 - (2.0 * torch.sum(p * t) + SMOOTH) / (torch.sum(p) + torch.sum(t) + SMOOTH)
    bce = F.binary_cross_entropy(p, t)
    m = _mirror(p)
    lap = m[:, :-2, 1:-1] + m[:, 2:, 1:-1] + m[:, 1:-1, :-2] + m[:, 1:-1, 2:] - 4.0 * p
    a, d, eps = cfg["reaction_threshold"], cfg["diffusion_coeff"], cfg["epsilon"]
    r = d * lap + p * (1.0 - p) * (p - a)
    gx = 0.5 * (m[:, 1:-1, 2:] - m[:, 1:-1, :-2])
    gy = 0.5 * (m[:, 2:, 1:-1] - m[:, :-2, 1:-1])
    pf = torch.mean(eps / 2.0 * (gx * gx + gy * gy) + (p * p) * (1.0 - p) ** 2 / eps)
    rd = torch.mean(r * r)
    total = (cfg["dice_weight"] * dice + cfg["bce_weight"] * bce
             + cfg["pde_weight"] * rd + cfg["phase_field_weight"] * pf)
    return total, {"pde_loss": rd, "phase_field_loss": pf}


def _boundary(m: torch.Tensor) -> torch.Tensor:
    eroded = -F.max_pool2d(-F.pad(m[:, None], (1, 1, 1, 1), value=0.0), 3, stride=1)[:, 0]
    return m * (1.0 - eroded)


def _near(b: torch.Tensor, tol: int) -> torch.Tensor:
    r = torch.arange(-tol, tol + 1, device=b.device, dtype=b.dtype)
    disk = ((r[:, None] ** 2 + r[None, :] ** 2) <= tol * tol).to(b.dtype)
    return (F.conv2d(b[:, None], disk[None, None], padding=tol)[:, 0] > 0.5).to(b.dtype)


def batch_metrics(p: torch.Tensor, t: torch.Tensor, tol: int = 2) -> dict:
    """Per-sample Dice, IoU and Boundary-F1 with a ``tol``-pixel tolerance
    (each (B,)) and the batch's global Dice, of probability maps ``p``
    thresholded at 0.5 against ``t``."""
    pb = (p > 0.5).to(torch.float32)
    inter, sp, st = (pb * t).sum((1, 2)), pb.sum((1, 2)), t.sum((1, 2))
    bp, bt = _boundary(pb), _boundary(t)
    prec = ((bp * _near(bt, tol)).sum((1, 2)) + SMOOTH) / (bp.sum((1, 2)) + SMOOTH)
    rec = ((bt * _near(bp, tol)).sum((1, 2)) + SMOOTH) / (bt.sum((1, 2)) + SMOOTH)
    return {
        "dice": (2.0 * inter + SMOOTH) / (sp + st + SMOOTH),
        "iou": (inter + SMOOTH) / (sp + st - inter + SMOOTH),
        "bf1": (2.0 * prec * rec + SMOOTH) / (prec + rec + SMOOTH),
        "global_dice": (2.0 * inter.sum() + SMOOTH) / (sp.sum() + st.sum() + SMOOTH),
    }
