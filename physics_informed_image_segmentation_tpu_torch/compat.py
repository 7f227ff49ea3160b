"""The reference package's class and function names, on tensors.

Counterpart of ``physics_informed_image_segmentation_tpu/compat.py``: the
reference implementation's public names and signatures over the port's
functional API (``ops.losses``, ``ops.pde``, ``train.evaluation``), so that
code written against the reference runs on the port unchanged:

* :class:`DiceBCELoss`, :class:`DiceBCEPDELoss` — callable losses with the
  reference's constructor keywords; each physics term only when its weight
  is above 0.  :class:`DiceBCEPDELoss` on CUDA tensors with a physics
  weight on goes through the fused physics kernel (one forward launch, one
  backward launch when its loss is differentiated), as the training
  objective does (:func:`..train.objective.make_loss_and_components`); on
  CPU tensors through its plain version;
* :class:`PDERegularization`, :func:`create_pde_regularization` — the
  reaction–diffusion operators as methods;
* :func:`compute_boundary_f1` — Boundary-F1 of the FIRST sample only
  (the reference's ``[0, 0]`` indexing);
* :func:`evaluate_on_test_set` — a COCO test split evaluated into the
  reference's dict of per-image metric arrays.

Fields are ``(B, 1, H, W)`` as in the reference, ``(B, H, W, 1)`` or
``(B, H, W)``: the stencils act on (H, W) in each
(:func:`..ops.losses.channel_axis`), so the JAX package's (W, C) stencils
on ``(B, H, W, 1)`` are not copied.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from .ops import pde as _pde
from .ops.losses import channel_axis, dice_bce_loss
from .ops.metrics import boundary_f1_per_sample
from .train.objective import LossConfig, make_loss_and_components

__all__ = [
    "DiceBCELoss",
    "DiceBCEPDELoss",
    "PDERegularization",
    "create_pde_regularization",
    "evaluate_on_test_set",
    "compute_boundary_f1",
]


def _on_hw(fn, u: torch.Tensor) -> torch.Tensor:
    """``fn`` with its stencils on (H, W): a field with a channel axis is
    squeezed first, and a field ``fn`` returns gets its axis back."""
    axis = channel_axis(u)
    if axis is None:
        return fn(u)
    out = fn(u.squeeze(axis))
    return out.unsqueeze(axis) if out.dim() == u.dim() - 1 else out


class PDERegularization:
    """Reaction–diffusion physics operators with the reference's class API;
    each method is the matching function of :mod:`.ops.pde`."""

    def __init__(self, diffusion_coeff: float = 1.0, reaction_threshold: float = 0.5):
        _pde.validate_pde_params(diffusion_coeff, reaction_threshold)
        self.diffusion_coeff = diffusion_coeff
        self.reaction_threshold = reaction_threshold

    def compute_laplacian(self, u: torch.Tensor) -> torch.Tensor:
        """5-point Laplacian with reflect (Neumann) boundaries."""
        return _on_hw(_pde.laplacian, u)

    def reaction_term(self, u: torch.Tensor) -> torch.Tensor:
        """Bistable reaction ``f(u) = u (1-u) (u-a)``."""
        return _pde.reaction_term(u, self.reaction_threshold)

    def compute_residual(self, u: torch.Tensor) -> torch.Tensor:
        """``r = D ∇²u + f(u)``."""
        return _on_hw(
            lambda v: _pde.pde_residual(v, self.diffusion_coeff, self.reaction_threshold), u)

    def compute_loss(self, u: torch.Tensor) -> torch.Tensor:
        """``mean(r²)``."""
        return _on_hw(
            lambda v: _pde.pde_residual_loss(v, self.diffusion_coeff, self.reaction_threshold),
            u)

    def compute_gradient_magnitude(self, u: torch.Tensor) -> torch.Tensor:
        """``|∇u|²`` with central differences."""
        return _on_hw(_pde.gradient_magnitude_sq, u)

    def compute_phase_field_loss(self, u: torch.Tensor, epsilon: float = 0.05) -> torch.Tensor:
        """Phase-field interface energy ``mean((ε/2)|∇u|² + (1/ε) u²(1-u)²)``."""
        if epsilon <= 0:
            raise ValueError("epsilon must be positive")
        return _on_hw(lambda v: _pde.phase_field_loss(v, epsilon), u)


def create_pde_regularization(
    diffusion_coeff: float = 1.0, reaction_threshold: float = 0.5
) -> PDERegularization:
    """The reference's factory of :class:`PDERegularization`."""
    return PDERegularization(diffusion_coeff=diffusion_coeff,
                             reaction_threshold=reaction_threshold)


class DiceBCELoss:
    """Dice + BCE loss with the reference's class API:
    ``loss = DiceBCELoss()(predictions, targets)``."""

    def __init__(self, dice_weight: float = 0.5, bce_weight: float = 0.5, smooth: float = 1e-6):
        self.dice_weight = dice_weight
        self.bce_weight = bce_weight
        self.smooth = smooth

    def __call__(self, predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return dice_bce_loss(predictions, targets, dice_weight=self.dice_weight,
                             bce_weight=self.bce_weight, smooth=self.smooth)

    forward = __call__


class DiceBCEPDELoss:
    """Dice + BCE + λ_RD·mean(r²) + λ_PF·phase-field, with the reference's
    constructor keywords; a physics term counts only when its weight is
    above 0.  CUDA tensors with a physics weight on go through the fused
    physics kernel, CPU tensors through its plain version (see the module
    docstring)."""

    def __init__(
        self,
        dice_weight: float = 0.5,
        bce_weight: float = 0.5,
        pde_weight: float = 1e-3,
        phase_field_weight: float = 0.0,
        smooth: float = 1e-6,
        diffusion_coeff: float = 1.0,
        reaction_threshold: float = 0.5,
        epsilon: float = 0.05,
    ):
        _pde.validate_pde_params(diffusion_coeff, reaction_threshold)
        self.dice_weight = dice_weight
        self.bce_weight = bce_weight
        self.pde_weight = pde_weight
        self.phase_field_weight = phase_field_weight
        self.smooth = smooth
        self.diffusion_coeff = diffusion_coeff
        self.reaction_threshold = reaction_threshold
        self.epsilon = epsilon
        self.pde_regularization = PDERegularization(diffusion_coeff, reaction_threshold)
        self._loss = make_loss_and_components(LossConfig(
            dice_weight=dice_weight, bce_weight=bce_weight, pde_weight=pde_weight,
            phase_field_weight=phase_field_weight, smooth=smooth,
            diffusion_coeff=diffusion_coeff, reaction_threshold=reaction_threshold,
            epsilon=epsilon))

    def __call__(self, predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return self._loss(predictions, targets)[0]

    forward = __call__


def _first_sample(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    axis = channel_axis(x)
    if axis is not None:
        x = x.squeeze(axis)
    return x[0] if x.dim() == 3 else x


def compute_boundary_f1(
    predictions,
    targets,
    threshold: float = 0.5,
    tolerance: int = 2,
    smooth: float = 1e-6,
) -> torch.Tensor:
    """Boundary-F1 of the FIRST sample only, whatever the batch size: the
    reference's ``[0, 0]``-indexed form.  For every sample use
    ``compute_boundary_f1_batch`` (:func:`.ops.metrics.boundary_f1_per_sample`).

    The channel axis of either layout (:func:`.ops.losses.channel_axis`) is
    dropped, then sample 0 is taken, as the reference's ``[0, 0]`` does."""
    p, t = _first_sample(predictions), _first_sample(targets)
    return boundary_f1_per_sample(p[None], t[None], threshold=threshold, tolerance=tolerance,
                                  smooth=smooth)[0]


def evaluate_on_test_set(
    model: Any,
    test_dir,
    test_json,
    device=None,
    batch_size: int = 8,
    threshold: float = 0.5,
    model_name: str = "Model",
    *,
    dtype: str = "f32",
) -> Dict[str, np.ndarray]:
    """Evaluate a model on a COCO test split with the reference's signature;
    returns its dict of per-image arrays (``dice_scores``, ``iou_scores``,
    ``boundary_f1_scores``, ``hausdorff_distances``) and prints its report.

    ``device`` is where the split and the model go (None: ``"cuda"``).
    ``model`` is one of:

    * a checkpoint path (``.pth``, or a ``.msgpack`` from the JAX package)
      of a base-64 U-Net, evaluated in ``dtype`` ("f32", the reference's
      evaluation precision, or "bf16");
    * an ``nn.Module``, moved to ``device`` and evaluated in ``dtype``;
    * a :class:`.serve.Predictor` on ``device``, evaluated in the
      Predictor's own precision: a bf16 Predictor under ``dtype="f32"``
      warns rather than lowering the precision silently.
    """
    from .data import DeviceDataset, load_split
    from .experiments.compare import load_unet_params
    from .serve import Predictor
    from .train.evaluation import evaluate_on_dataset
    from .utils.device import resolve_device, set_precision

    dev = resolve_device(device)
    precision = set_precision(dtype)
    if isinstance(model, (str, Path)):
        model, _ = load_unet_params(model, precision=dtype, device=dev)
    elif isinstance(model, Predictor):
        if model.device != dev:
            raise ValueError(f"the Predictor runs on {model.device}, the evaluation on {dev}")
        precision = "bf16" if model.dtype == torch.bfloat16 else "f32"
        if dtype == "f32" and precision == "bf16":
            warnings.warn(
                "evaluate_on_test_set(dtype='f32') received a Predictor whose model computes "
                "in bfloat16; evaluation runs in the Predictor's dtype (bf16 eval noise can "
                "flip paired-test significance — rebuild the Predictor with precision='f32' "
                "or pass the checkpoint path instead)",
                stacklevel=2,
            )
        model = model.model
    elif isinstance(model, torch.nn.Module):
        model = model.to(dev)
    else:
        raise TypeError("model must be a checkpoint path, an nn.Module or a Predictor")

    src = load_split(test_dir, test_json)
    data = DeviceDataset.from_numpy(src.images, src.masks, dev)
    return evaluate_on_dataset(model, data, batch_size=batch_size, model_name=model_name,
                               threshold=threshold, precision=precision)
