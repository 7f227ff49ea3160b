"""Loss configuration and loss-function factory.

Counterpart of ``physics_informed_image_segmentation_tpu/train/objective.py``.
``backend`` selects the physics implementation:

  * ``"torch"`` — plain PyTorch stencils (:mod:`..ops.pde`), any device;
  * ``"cuda"``  — the fused CUDA kernel (:mod:`..ops.physics_kernel`);
    raises on CPU tensors;
  * ``"auto"``  — the kernel for CUDA tensors, the plain path for CPU
    tensors.

The kernel tiles rows, so it takes fields of any size: there is no
field-size cap and no fallback to the plain path.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import losses, pde

__all__ = ["LossConfig", "make_loss_and_components"]

_BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static objective description."""

    dice_weight: float = 0.5
    bce_weight: float = 0.5
    pde_weight: float = 0.0
    phase_field_weight: float = 0.0
    smooth: float = 1e-6
    diffusion_coeff: float = 1.0
    reaction_threshold: float = 0.5
    epsilon: float = 0.05
    use_reaction_term: bool = True
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected one of {_BACKENDS}")
        if self.pde_weight > 0 or self.phase_field_weight > 0:
            pde.validate_pde_params(self.diffusion_coeff, self.reaction_threshold)
        if self.phase_field_weight > 0 and self.epsilon <= 0:
            raise ValueError("epsilon must be positive")

    @property
    def uses_physics(self) -> bool:
        return self.pde_weight > 0 or self.phase_field_weight > 0


def _total(cfg: LossConfig, comps: dict) -> torch.Tensor:
    return (
        cfg.dice_weight * comps["dice_loss"]
        + cfg.bce_weight * comps["bce_loss"]
        + cfg.pde_weight * comps["pde_loss"]
        + cfg.phase_field_weight * comps["phase_field_loss"]
    )


def make_loss_and_components(cfg: LossConfig, reduce=None, physics_sums=None):
    """Returns ``f(pred, target, mask) -> (total_loss, components_dict)``.

    The components dict always has keys dice_loss / bce_loss / pde_loss /
    phase_field_loss (disabled terms are 0.0), computed in the same pass
    as the loss.

    ``reduce``: for a batch sharded over ranks, a differentiable sum over
    the ranks (:func:`..parallel.mesh.all_sum`).  The per-image sums and
    the valid-pixel count are then reduced before Dice's ratio and the
    means are formed, so the loss is that of the global batch: the kernel
    K1 when it would serve the batch, else its plain version.

    ``physics_sums(u, m)`` (with ``reduce``): the per-image masked
    ``[Σr², Σpf]`` of a band of a space-sharded batch, whose stencils need
    the neighbouring bands (:func:`..parallel.halo.halo_physics_sums`, K3);
    Dice and BCE are then summed on the band in plain PyTorch.
    """

    def kernel_loss_fn(pred, target, mask=None, plain=False):
        from ..ops import physics_kernel

        source = dict(plain=plain) if physics_sums is None else dict(physics_sums=physics_sums)

        comps = physics_kernel.fused_loss_components(
            pred,
            target,
            diffusion_coeff=cfg.diffusion_coeff,
            reaction_threshold=cfg.reaction_threshold,
            epsilon=cfg.epsilon,
            use_reaction_term=cfg.use_reaction_term,
            smooth=cfg.smooth,
            mask=mask,
            need_pde=cfg.pde_weight > 0,
            need_phase_field=cfg.phase_field_weight > 0,
            reduce=reduce,
            **source,
        )
        return _total(cfg, comps), comps

    def plain_loss_fn(pred, target, mask=None):
        comps = losses.loss_components(
            pred,
            target,
            pde_weight=cfg.pde_weight,
            phase_field_weight=cfg.phase_field_weight,
            smooth=cfg.smooth,
            diffusion_coeff=cfg.diffusion_coeff,
            reaction_threshold=cfg.reaction_threshold,
            epsilon=cfg.epsilon,
            use_reaction_term=cfg.use_reaction_term,
            mask=mask,
        )
        return _total(cfg, comps), comps

    if cfg.backend == "torch" and reduce is None:
        return plain_loss_fn

    def loss_fn(pred, target, mask=None):
        if cfg.backend == "cuda" and not pred.is_cuda:
            raise ValueError(
                f"backend='cuda' needs CUDA tensors; got a tensor on {pred.device}"
            )
        # Dice+BCE alone (Stage I) has no kernel: the plain path serves it
        use_kernel = pred.is_cuda and cfg.uses_physics and cfg.backend != "torch"
        if reduce is not None:
            return kernel_loss_fn(pred, target, mask, plain=not use_kernel)
        if use_kernel:
            return kernel_loss_fn(pred, target, mask)
        return plain_loss_fn(pred, target, mask)

    return loss_fn
