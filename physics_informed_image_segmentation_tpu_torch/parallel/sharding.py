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
their ``shard`` hook (:class:`MeshShard`).  With ``spatial``, a band's
objective and metrics need rows of the bands beside it:

* Dice and BCE: the masked sums of the band, all-summed before the ratio;
* the physics: the band with a one-pixel ghost ring from the exchange
  (:func:`.halo.halo_physics_sums`), whose per-image sums K3 takes on
  CUDA tensors (its plain version on CPU tensors), times the sample mask,
  all-summed and divided by ``Σvalid · H · W`` of the global batch;
* per-sample Dice and IoU: each sample's three sums all-summed over
  ``space`` before its ratio;
* Boundary-F1: the band with ``tolerance + 1`` rows of its neighbours
  (zero rows at the image's edges): the erosion reads one row, the disk
  dilation ``tolerance``; its four counts are taken over the band's own
  rows and all-summed over ``space``, so they are the unsharded counts.

The per-sample values are then gathered over ``data`` in plan order, and
every rank sums them as one process would.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import metrics as M
from ..ops.padded_physics_kernel import padded_physics_sums, padded_physics_sums_reference
from ..train.engine import TrainState, make_eval_epoch_fn, make_train_epoch_fn
from ..train.objective import LossConfig, make_loss_and_components
from .halo import halo_exchange_pad, halo_physics_sums
from .mesh import (
    SPACE_AXIS,
    Mesh,
    all_reduce_grads,
    all_sum,
    batch_sharding,
    batch_space_sharding,
)
from .spatial_unet import sharded_forward_nhwc

__all__ = [
    "MeshShard",
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

    def loss_fn(self, cfg: LossConfig, sums_fn=None):
        """The objective of the global batch from this rank's block.  With
        ``spatial``, a band's physics sums come from ``sums_fn`` on its
        ghost-ringed block: by default K3 (its plain version on CPU
        tensors), the plain stencils with ``cfg.backend == "torch"``."""
        if not self.spatial:
            return make_loss_and_components(cfg, self.all_sum)
        if sums_fn is None:
            sums_fn = (padded_physics_sums_reference if cfg.backend == "torch"
                       else padded_physics_sums)

        def physics_sums(u, m):
            return halo_physics_sums(u, self.mesh, cfg.diffusion_coeff, cfg.reaction_threshold,
                                     cfg.epsilon, cfg.use_reaction_term, sums_fn, valid=m)

        return make_loss_and_components(cfg, self.all_sum, physics_sums)

    def sample_metrics(self, p2, t2) -> list:
        """Per-sample Dice, IoU and Boundary-F1 of the global batch, three
        (B,) tensors in plan order, from this rank's (B_loc, H_loc, W)
        block of predictions and targets."""
        pred_bin = (p2 > M.THRESHOLD).to(p2.dtype)
        if self.spatial:
            k = M.BOUNDARY_TOLERANCE + 1
            both = halo_exchange_pad(torch.stack([pred_bin, t2]), self.mesh, "zero", rows=k)
            counts = M.boundary_counts(both[0], both[1], halo=k)
        else:
            counts = M.boundary_counts(pred_bin, t2)
        sums = torch.cat([M.overlap_sums(p2, t2), counts], dim=1)
        if self.spatial:
            sums = all_sum(sums, self.mesh, (SPACE_AXIS,))
        per = torch.stack([M.dice_from_sums(sums[:, :3]), M.iou_from_sums(sums[:, :3]),
                           M.boundary_f1_from_counts(sums[:, 3:])], dim=1)
        if self.mesh.data > 1:
            parts = [torch.empty_like(per) for _ in range(self.mesh.data)]
            dist.all_gather(parts, per, group=self.mesh.data_group)
            per = torch.cat(parts)
        return [c.contiguous() for c in per.unbind(1)]


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
    """``(train_epoch_fn, eval_epoch_fn)`` sharded over the mesh: the
    signatures and results of :func:`..train.engine.make_train_epoch_fn`
    and :func:`..train.engine.make_eval_epoch_fn`, a drop-in for
    :func:`..train.engine.train_stage`.  Every rank passes the same
    replicated data and plan and gets the same metrics.

    Samples are sharded over ``data``; ``spatial=True`` also shards image
    height over ``space`` (see the module docstring): a band must have a
    height divisible by 16 (the U-Net's poolings) and at least
    Boundary-F1's tolerance + 1 rows, else the epoch raises ``ValueError``.
    """
    shard = MeshShard(mesh, spatial=spatial)
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
      convolutions exchange one-row halos (:mod:`.spatial_unet`), and the
      objective is :meth:`MeshShard.loss_fn`'s, unmasked: the physics terms
      run on halo-padded bands;
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
    sums_fn = padded_physics_sums if halo_physics else padded_physics_sums_reference
    components = shard.loss_fn(loss_cfg, sums_fn)

    def step(state: TrainState, x, y):
        x, y = shard.local(x), shard.local(y)
        state.model.train()
        pred = shard.forward(state.model, x, precision, state.dropout_generator)
        loss = components(pred, y)[0]
        grads = torch.autograd.grad(loss, state.optimizer.params)
        state.optimizer.step(shard.reduce_grads(grads))
        return state, loss.detach()

    return step
