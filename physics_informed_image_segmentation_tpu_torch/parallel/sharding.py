"""Sharded training: data-parallel epochs and the data×space train step.

Counterpart of ``physics_informed_image_segmentation_tpu/parallel/sharding.py``.
The JAX package runs ONE program over the global batch and lets XLA
place the collectives; here every rank runs the same Python over its
share, and the collectives are written out:

* every rank holds the replicated global batch and cuts its share
  (samples over ``data``, and with ``spatial`` a band of rows over
  ``space``);
* the losses' sums (Dice's three sums, BCE's and the physics terms' sums,
  the valid-pixel count) are all-reduced before any ratio is formed, so
  every rank computes the loss of the global batch, as the JAX program
  does; averaging per-rank losses would give another loss and another
  gradient;
* the gradients are summed over all ranks (each rank's gradient is that
  of its own terms of the global loss), so every rank applies the
  single-process update to its replica of the train state.

``make_sharded_epoch_fns`` reuses the engine's epoch functions through
their ``shard`` hook (:class:`MeshShard`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import losses as L
from ..ops.padded_physics_kernel import padded_physics_sums, padded_physics_sums_reference
from ..train.engine import TrainState, make_eval_epoch_fn, make_train_epoch_fn
from ..train.objective import LossConfig, make_loss_and_components
from .halo import physics_means
from .mesh import (
    DATA_AXIS,
    Mesh,
    all_reduce_grads,
    all_sum,
    batch_sharding,
    batch_space_sharding,
)
from .spatial_unet import sharded_forward_nhwc

__all__ = [
    "make_sharded_epoch_fns",
    "shard_train_state",
    "make_sharded_train_step",
]


class MeshShard:
    """How a step runs on a batch sharded over a ``(data, space)`` mesh:
    the ``shard`` of :func:`..train.engine.make_train_step_fn`."""

    def __init__(self, mesh: Mesh, spatial: bool):
        self.mesh, self.spatial = mesh, spatial
        self._cut = batch_space_sharding(mesh) if spatial else batch_sharding(mesh)
        self._cut_samples = batch_sharding(mesh)

    def local(self, x):
        # per-sample vectors (validity) are cut over samples only
        return self._cut(x) if x.dim() > 1 else self._cut_samples(x)

    def forward(self, model, x, precision, generator=None):
        return sharded_forward_nhwc(model, x, precision, generator, self.mesh,
                                    spatial=self.spatial)

    def all_sum(self, t):
        return all_sum(t, self.mesh)

    def reduce_grads(self, grads):
        return all_reduce_grads(grads)


@torch.no_grad()
def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Make every rank's train state rank 0's: parameters and buffers, the
    optimizer's moments and step count, and the dropout generator's state
    are broadcast from rank 0, in place.  Works for every optimizer of
    :func:`..train.engine.create_train_state` (``state_dict`` lists the
    moments themselves)."""
    device = mesh.device
    opt = state.optimizer.state_dict()
    tensors = [*state.model.parameters(), *state.model.buffers(), *opt["m"], *opt["v"]]
    for t in tensors:
        if t.numel():
            dist.broadcast(t, src=0)
    count = torch.tensor([state.optimizer.count], dtype=torch.int64, device=device)
    dist.broadcast(count, src=0)
    state.optimizer.count = int(count.item())
    gen = state.dropout_generator.get_state().to(device)
    dist.broadcast(gen, src=0)
    state.dropout_generator.set_state(gen.cpu())
    return state


def make_sharded_epoch_fns(
    loss_cfg: LossConfig,
    mesh: Mesh,
    *,
    spatial: bool = False,
    compute_metrics: bool = True,
    precision: str = "f32",
):
    """``(train_epoch_fn, eval_epoch_fn)`` sharded over the mesh's ``data``
    axis: the signatures and results of :func:`..train.engine.make_train_epoch_fn`
    and :func:`..train.engine.make_eval_epoch_fn`, a drop-in for
    :func:`..train.engine.train_stage`.  Every rank passes the same
    replicated data and plan and gets the same metrics.

    ``spatial=True`` is not ported yet: Boundary-F1's exact-disk dilation
    (``ops/metrics.py``) reads as far as its tolerance radius across a
    band's edge, so a space-sharded metric needs a halo that wide.
    """
    if spatial:
        raise NotImplementedError(
            "space-sharded epochs are not ported yet: Boundary-F1's disk dilation "
            "needs a halo as wide as its tolerance radius"
        )
    shard = MeshShard(mesh, spatial=False)
    kw = dict(compute_metrics=compute_metrics, precision=precision, shard=shard)
    return make_train_epoch_fn(loss_cfg, **kw), make_eval_epoch_fn(loss_cfg, **kw)


def make_sharded_train_step(
    loss_cfg: LossConfig,
    mesh: Mesh,
    *,
    spatial: bool = True,
    halo_physics: bool = False,
    precision: str = "f32",
):
    """``step(state, x, y) -> (state, loss)``: one optimizer step on the
    global (B, H, W, 1) batch ``x``, ``y`` (replicated on every rank; each
    rank cuts its share), with the loss of the global batch.

    * ``spatial``: image height is sharded over ``space`` too; the U-Net's
      convolutions exchange one-row halos (:mod:`.spatial_unet`), Dice/BCE
      are unmasked, and the physics terms run on halo-padded bands;
    * ``halo_physics=True`` (needs ``spatial``): those physics terms take
      the fused padded-block op, K3 on CUDA
      (:func:`.halo.halo_physics_loss_pallas`); without it, its plain
      stencils;
    * neither: the unmasked Stage objective of
      :func:`..train.objective.make_loss_and_components` over the data axis.
    """
    if halo_physics and not spatial:
        raise ValueError("halo_physics requires spatial=True")
    shard = MeshShard(mesh, spatial)

    if spatial:
        sums_fn = padded_physics_sums if halo_physics else padded_physics_sums_reference

        def loss_fn(pred, y):
            p, t = pred.to(torch.float32), y.to(torch.float32)
            n = torch.tensor(float(p.numel()), dtype=torch.float32, device=p.device)
            inter, sp, st, bce, n = shard.all_sum(torch.stack([
                torch.sum(p * t), torch.sum(p), torch.sum(t),
                torch.sum(L.bce_elementwise(p, t)), n,
            ])).unbind()
            dice = (2.0 * inter + loss_cfg.smooth) / (sp + st + loss_cfg.smooth)
            total = loss_cfg.dice_weight * (1.0 - dice) + loss_cfg.bce_weight * (bce / n)
            if loss_cfg.uses_physics:
                rd, pf = physics_means(
                    pred[..., 0], mesh, loss_cfg.diffusion_coeff, loss_cfg.reaction_threshold,
                    loss_cfg.epsilon, loss_cfg.use_reaction_term, DATA_AXIS, sums_fn)
                total = total + loss_cfg.pde_weight * rd + loss_cfg.phase_field_weight * pf
            return total
    else:
        components = make_loss_and_components(loss_cfg, shard.all_sum)

        def loss_fn(pred, y):
            return components(pred, y)[0]

    def step(state: TrainState, x, y):
        x, y = shard.local(x), shard.local(y)
        state.model.train()
        pred = shard.forward(state.model, x, precision, state.dropout_generator)
        loss = loss_fn(pred, y)
        grads = torch.autograd.grad(loss, state.optimizer.params)
        state.optimizer.step(shard.reduce_grads(grads))
        return state, loss.detach()

    return step
