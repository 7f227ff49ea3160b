"""Training engine: train and eval epochs, early stopping, the stage loop.

Counterpart of ``physics_informed_image_segmentation_tpu/train/engine.py``.
An epoch is a Python loop over the ``(idx, valid)`` plan of
:func:`..data.pipeline.epoch_batch_indices`: each batch is gathered on the
device, padded slots are masked out of the loss and metrics, and the
per-batch results stay on the device until one host sync at the end of
the epoch.

Metric semantics kept from the JAX package:
  * train ``dice_score`` is the mean of per-sample Dice; validation
    ``dice_score`` is the mean over batches of the global-batch Dice
    (early stopping keys on the latter);
  * losses are averaged per batch with equal batch weight, the ragged
    final batch included;
  * best-epoch tracking records metrics only: the returned model holds
    the last epoch's weights.

A stage can write full train-state checkpoints and resume from one: each
epoch's shuffle is drawn from a generator seeded by (shuffle seed,
epoch), and the dropout generator's state travels in the checkpoint, so a
resumed stage is bit-identical to an uninterrupted one.

Besides the epoch: :func:`make_train_epochs_fn` (E epochs a call, one host
sync), :func:`make_train_chunk_fn` (K streamed batches a call, see
:mod:`..data.streaming`) and the ``augment=`` hook (:mod:`..data.augment`).

Under ``torch.profiler`` the stage and its steps are spans
(:func:`..utils.profiling.span`): ``piis.epoch`` holds ``piis.plan`` (the
shuffle and its plan), one ``piis.step`` a step (the batch's gather,
``piis.forward``, ``piis.objective``, ``piis.backward``, ``piis.optimizer``,
``piis.metrics``), ``piis.sync``, ``piis.val`` (its own forward, objective,
metrics and sync) and ``piis.log`` (best tracking, files, callback, early
stopping); the validation plan before the first epoch is a ``piis.plan``.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models import require_unet
from ..ops import metrics as M
from ..utils.device import autocast
from ..utils.profiling import span
from .adamw_kernel import FusedAdamW
from .objective import LossConfig, make_loss_and_components
from .optim import AdamW, FlatAdamW, GroupedAdamW, LowPrecisionAdamW

__all__ = [
    "TrainState",
    "create_train_state",
    "tree_params",
    "forward_nhwc",
    "make_train_step_fn",
    "make_train_epoch_fn",
    "make_train_epochs_fn",
    "make_train_chunk_fn",
    "make_eval_epoch_fn",
    "EarlyStopping",
    "train_stage",
]

_LOSS_KEYS = ("loss", "dice_loss", "bce_loss", "pde_loss", "phase_field_loss")


@dataclass
class TrainState:
    """The model (holding the parameters), its optimizer and the dropout
    generator (on the model's device); ``flat_params``, with
    ``create_train_state(flat=True)``, the one buffer the parameters are
    views of."""

    model: torch.nn.Module
    optimizer: AdamW
    dropout_generator: torch.Generator
    flat_params: Optional[torch.Tensor] = None

    @property
    def step(self) -> int:
        return self.optimizer.count


_OPTIMIZERS = {
    "adamw": AdamW,
    "flat_adamw": FlatAdamW,
    "grouped_adamw": GroupedAdamW,
    "pallas_adamw": FusedAdamW,
    "bf16m_adamw": functools.partial(LowPrecisionAdamW, m_dtype=torch.bfloat16),
    "bf16mv_adamw": functools.partial(LowPrecisionAdamW, m_dtype=torch.bfloat16,
                                      v_dtype=torch.bfloat16),
}


def create_train_state(
    model: torch.nn.Module,
    learning_rate: float,
    weight_decay: float = 1e-5,
    *,
    optimizer: str = "adamw",
    dropout_seed: int = 0,
    flat: bool = False,
) -> TrainState:
    """A fresh optimizer over ``model``'s parameters, as each stage starts one.

    ``optimizer`` takes the JAX package's names:

    * ``"adamw"``: :class:`.optim.AdamW`, optax's AdamW (the default);
    * ``"flat_adamw"`` / ``"grouped_adamw"``: the same update with flat
      moment storage for all / the small parameters (bit-identical);
    * ``"pallas_adamw"``: the same update as one hand-written CUDA kernel
      launch a step on the GPU (:mod:`.adamw_kernel`; bit-identical);
    * ``"bf16m_adamw"`` / ``"bf16mv_adamw"``: m / m and v stored in
      bfloat16, computed in float32 (an approximation).

    ``flat=True`` stores the parameters as views into one float32 buffer
    (``state.flat_params``), in ``model.parameters()``'s order: the
    ``state_dict`` keys stay, every optimizer updates the views in place,
    and trajectories are bit-identical to ``flat=False``.  Moving the
    model (``.to``) afterwards would give it new tensors and undo it.
    """
    if optimizer not in _OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {optimizer!r}; expected 'adamw', "
            "'flat_adamw', 'grouped_adamw', 'pallas_adamw', "
            "'bf16m_adamw' or 'bf16mv_adamw'"
        )
    device = next(model.parameters()).device
    generator = torch.Generator(device=device)
    generator.manual_seed(dropout_seed)
    flat_params = _flatten_parameters(model) if flat else None
    opt = _OPTIMIZERS[optimizer](list(model.parameters()), learning_rate, weight_decay)
    return TrainState(model, opt, generator, flat_params)


@torch.no_grad()
def _flatten_parameters(model: torch.nn.Module) -> torch.Tensor:
    """Make ``model``'s parameters views into one new buffer, values kept."""
    params = list(model.parameters())
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError("flat=True needs float32 parameters")
    buf = torch.cat([p.reshape(-1) for p in params])
    off = 0
    for p in params:
        p.data = buf[off:off + p.numel()].view(p.shape)
        off += p.numel()
    return buf


def tree_params(state: TrainState) -> dict:
    """The parameters by ``state_dict`` name, whatever the storage mode."""
    return dict(state.model.named_parameters())


def forward_nhwc(model, x: torch.Tensor, precision: str, generator=None) -> torch.Tensor:
    """(B, H, W, C) images → (B, H, W, C_out) float32 probabilities.

    With C = 1 the NHWC↔NCHW permutes are views.
    """
    with autocast(x.device, precision):
        out = model(x.permute(0, 3, 1, 2), generator)
    return out.permute(0, 2, 3, 1)


def _sample_mask(valid: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) validity → broadcastable mask over (B, H, W[, C])."""
    return valid.reshape((valid.shape[0],) + (1,) * (ndim - 1))


def _per_sample_metrics(p2, t2) -> list:
    return [M.dice_score_per_sample(p2, t2), M.iou_score_per_sample(p2, t2),
            M.boundary_f1_per_sample(p2, t2)]


def _batch_metrics(pred, target, valid, shard=None) -> dict:
    """Per-sample Dice/IoU/Boundary-F1 sums over valid samples.  With
    ``shard``, ``pred`` and ``target`` are this rank's block and ``valid``
    the global batch's: ``shard.sample_metrics`` gives every sample's
    values in plan order, so the sums are those of one process."""
    p2 = pred[..., 0] if pred.dim() == 4 else pred
    t2 = target[..., 0] if target.dim() == 4 else target
    dice, iou, bf1 = (_per_sample_metrics(p2, t2) if shard is None
                      else shard.sample_metrics(p2, t2))
    return {
        "dice_sum": torch.sum(dice * valid),
        "iou_sum": torch.sum(iou * valid),
        "bf1_sum": torch.sum(bf1 * valid),
        "n": torch.sum(valid),
    }


def _to_host(outs: list[dict]) -> dict:
    """Stack per-batch scalars and bring them to the host in one sync."""
    keys = list(outs[0])
    with span("piis.sync"):
        stacked = torch.stack([torch.stack([o[k].float() for k in keys]) for o in outs])
        cols = stacked.cpu().double()
    return {k: cols[:, i] for i, k in enumerate(keys)}


def _per_sample_means(cols: dict, out: dict, dice_key: str) -> None:
    n = cols["n"].sum()
    out[dice_key] = float(cols["dice_sum"].sum() / n)
    out["iou_score"] = float(cols["iou_sum"].sum() / n)
    out["boundary_f1_score"] = float(cols["bf1_sum"].sum() / n)


def make_train_step_fn(loss_cfg: LossConfig, *, compute_metrics: bool = True,
                       precision: str = "f32", shard=None, augment=None):
    """``step(state, x, y, valid) -> (state, out)``: one optimizer step on
    a (B, H, W, 1) batch; ``out`` holds device scalars.

    ``shard`` (``None`` for one process; :class:`..parallel.sharding.MeshShard`
    makes one) runs the step on a batch sharded over ranks.  The batch is
    then the global one, replicated on every rank, and ``shard`` provides
    ``local(x)`` (this rank's share of a batch tensor),
    ``forward(model, x, precision, generator)`` (the model on that share),
    ``loss_fn(loss_cfg)`` (the objective with its sums added over the
    ranks before any ratio), ``all_sum(t)`` (a differentiable sum over the
    ranks), ``sample_metrics(pred, target)`` (every
    sample's Dice, IoU and Boundary-F1, in plan order) and
    ``reduce_grads(grads)`` (the gradients summed over the ranks): the
    losses and metrics are those of the global batch, and every rank
    applies the global gradient.

    ``augment(generator, x, y) -> (x, y)`` (:mod:`..data.augment`) transforms
    the global batch before the forward, with codes drawn from the train
    state's dropout generator: a checkpoint carries the augmentation stream
    with the dropout stream, so a resumed run draws what an uninterrupted
    one does.  The JAX package draws them from ``fold_in(dropout_key, 1)``,
    which a ``torch.Generator`` cannot reproduce: trajectories with
    augmentation are compared with JAX's by their transforms, not draws.

    Each call is span ``piis.step`` (:func:`..utils.profiling.span`).
    """
    body = _step_body(loss_cfg, compute_metrics, precision, shard, augment)

    def step(state: TrainState, x, y, valid):
        with span("piis.step"):
            return body(state, x, y, valid)

    return step


def _step_body(loss_cfg, compute_metrics, precision, shard, augment):
    """The step of :func:`make_train_step_fn` without its ``piis.step``
    span, for callers whose span also covers the batch's gather."""
    loss_fn = make_loss_and_components(loss_cfg) if shard is None else shard.loss_fn(loss_cfg)
    forward = forward_nhwc if shard is None else shard.forward

    def step(state: TrainState, x, y, valid):
        if augment is not None:
            x, y = augment(state.dropout_generator, x, y)
        valid_all = valid
        if shard is not None:
            x, y, valid = shard.local(x), shard.local(y), shard.local(valid)
        state.model.train()
        with span("piis.forward"):
            pred = forward(state.model, x, precision, state.dropout_generator)
        with span("piis.objective"):
            total, comps = loss_fn(pred, y, _sample_mask(valid, x.dim()))
        with span("piis.backward"):
            grads = torch.autograd.grad(total, state.optimizer.params)
        if shard is not None:
            grads = shard.reduce_grads(grads)
        with span("piis.optimizer"):
            state.optimizer.step(grads)
        out = {"loss": total.detach(), **{k: v.detach() for k, v in comps.items()}}
        if compute_metrics:
            with span("piis.metrics"):
                out.update(_batch_metrics(pred.detach(), y, valid_all, shard))
        return state, out

    return step


def _epoch_results(cols: dict, compute_metrics: bool) -> dict:
    results = {k: float(cols[k].mean()) for k in _LOSS_KEYS}
    if compute_metrics:
        _per_sample_means(cols, results, "dice_score")
    return results


def _make_steps_fn(loss_cfg, compute_metrics, precision, shard, augment):
    """``steps(state, images, masks, idx, valid) -> (state, outs)``: one
    epoch's steps, their outputs left on the device."""
    step = _step_body(loss_cfg, compute_metrics, precision, shard, augment)

    def steps(state, images, masks, idx, valid):
        outs = []
        for b in range(idx.shape[0]):
            with span("piis.step"):
                state, out = step(state, images[idx[b]], masks[idx[b]], valid[b])
            outs.append(out)
        return state, outs

    return steps


def make_train_epoch_fn(loss_cfg: LossConfig, *, compute_metrics: bool = True,
                        precision: str = "f32", shard=None, augment=None):
    """``epoch_fn(state, images, masks, idx, valid) -> (state, metrics)``
    with ``metrics`` host floats; ``idx``/``valid`` are (nb, B).  ``shard``
    and ``augment`` as in :func:`make_train_step_fn`."""
    steps = _make_steps_fn(loss_cfg, compute_metrics, precision, shard, augment)

    def epoch_fn(state: TrainState, images, masks, idx, valid):
        state, outs = steps(state, images, masks, idx, valid)
        return state, _epoch_results(_to_host(outs), compute_metrics)

    return epoch_fn


def make_train_epochs_fn(loss_cfg: LossConfig, *, compute_metrics: bool = True,
                         precision: str = "f32", shard=None, augment=None):
    """``fn(state, images, masks, idx, valid) -> (state, metrics)``: E
    epochs in one call, ``idx``/``valid`` of shape (E, nb, B) (one
    :func:`..data.pipeline.epoch_batch_indices` plan per epoch, stacked),
    each metric a float64 numpy array of E values, equal to those of E
    calls of :func:`make_train_epoch_fn`.  One host sync for all E epochs:
    for fixed-budget stages and benchmarks, where no host decision (early
    stopping) falls between epochs."""
    steps = _make_steps_fn(loss_cfg, compute_metrics, precision, shard, augment)

    def epochs_fn(state: TrainState, images, masks, idx, valid):
        outs = []
        for e in range(idx.shape[0]):
            state, epoch_outs = steps(state, images, masks, idx[e], valid[e])
            outs += epoch_outs
        cols = _to_host(outs)
        nb = idx.shape[1]
        per_epoch = [_epoch_results({k: v[e * nb:(e + 1) * nb] for k, v in cols.items()},
                                    compute_metrics) for e in range(idx.shape[0])]
        return state, {k: np.array([r[k] for r in per_epoch]) for k in per_epoch[0]}

    return epochs_fn


def make_train_chunk_fn(loss_cfg: LossConfig, *, compute_metrics: bool = True,
                        precision: str = "f32", shard=None):
    """``chunk(state, xs, ys, valids) -> (state, metrics)``: K streamed
    batches in one call, ``xs``/``ys`` (K, B, H, W, 1) and ``valids`` (K, B)
    (:func:`..data.streaming.chunk_batches`), each step that of
    :func:`make_train_step_fn`; ``metrics`` holds device tensors with a
    leading axis K.

    A step whose ``valid`` is all zero (a chunk's padding) is skipped: the
    parameters, moments, step count and dropout generator are left as they
    were (no optimizer launch either), so the chunk equals stepping its
    real batches one by one.  Its metrics are the JAX package's for such a
    step: NaN for the loss and the enabled means, a Dice loss of 0, and 0
    for the sums and ``n``.  ``valids`` is read on the host once a chunk.
    The U-Net's path only: another model raises ``ValueError``.
    """
    step = make_train_step_fn(loss_cfg, compute_metrics=compute_metrics, precision=precision,
                              shard=shard)

    def chunk(state: TrainState, xs, ys, valids):
        require_unet(state.model, "the streamed chunks")
        with span("piis.sync"):
            real = (valids.sum(dim=1) > 0).tolist()
        outs = []
        for k, is_real in enumerate(real):
            if is_real:
                state, out = step(state, xs[k], ys[k], valids[k])
            else:
                out = _padding_step_out(loss_cfg, valids.device, compute_metrics)
            outs.append(out)
        return state, {key: torch.stack([o[key] for o in outs]) for key in outs[0]}

    return chunk


def _padding_step_out(loss_cfg: LossConfig, device, compute_metrics: bool) -> dict:
    """What the objective gives a batch without a valid sample: Dice's
    ratio s/s, so a Dice loss of 0; its means 0/0; disabled terms 0."""
    nan = torch.full((), float("nan"), device=device)
    zero = torch.zeros((), device=device)
    out = {"loss": nan, "dice_loss": zero, "bce_loss": nan,
           "pde_loss": nan if loss_cfg.pde_weight > 0 else zero,
           "phase_field_loss": nan if loss_cfg.phase_field_weight > 0 else zero}
    if compute_metrics:
        out.update(dice_sum=zero, iou_sum=zero, bf1_sum=zero, n=zero)
    return out


def make_eval_epoch_fn(loss_cfg: LossConfig, *, compute_metrics: bool = True,
                       precision: str = "f32", shard=None):
    """``epoch_fn(model, images, masks, idx, valid) -> metrics``: a
    validation pass without gradients.  ``dice_score`` is the batch-mean
    of the global thresholded Dice; ``iou_score`` / ``boundary_f1_score``
    (and ``per_sample_dice``) are per-sample means.  ``shard`` as in
    :func:`make_train_step_fn`."""
    loss_fn = make_loss_and_components(loss_cfg) if shard is None else shard.loss_fn(loss_cfg)
    forward = forward_nhwc if shard is None else shard.forward
    reduce = None if shard is None else shard.all_sum

    @torch.no_grad()
    def epoch_fn(model, images, masks, idx, valid):
        model.eval()
        outs = []
        for b in range(idx.shape[0]):
            x, y, valid_all = images[idx[b]], masks[idx[b]], valid[b]
            valid_b = valid_all
            if shard is not None:
                x, y, valid_b = shard.local(x), shard.local(y), shard.local(valid_all)
            with span("piis.forward"):
                pred = forward(model, x, precision)
            with span("piis.objective"):
                total, comps = loss_fn(pred, y, _sample_mask(valid_b, x.dim()))
            out = {"loss": total, **comps}
            with span("piis.metrics"):
                p2, y2 = pred[..., 0], y[..., 0]
                out["global_dice"] = M.dice_score(p2, y2, mask=_sample_mask(valid_b, p2.dim()),
                                                  reduce=reduce)
                if compute_metrics:
                    out.update(_batch_metrics(pred, y, valid_all, shard))
            outs.append(out)
        cols = _to_host(outs)
        results = {k: float(cols[k].mean()) for k in _LOSS_KEYS}
        results["dice_score"] = float(cols["global_dice"].mean())
        if compute_metrics:
            _per_sample_means(cols, results, "per_sample_dice")
        return results

    return epoch_fn


class EarlyStopping:
    """Patience counter on a monitored score."""

    def __init__(self, patience: int = 10, min_delta: float = 1e-4, mode: str = "max"):
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.counter = 0
        self.best_score: Optional[float] = None
        self.best_epoch = 0
        self.early_stop = False

    def __call__(self, score: float, epoch: int) -> bool:
        if self.best_score is None:
            self.best_score = score
            self.best_epoch = epoch
            return False
        if self.mode == "max":
            improved = score > self.best_score + self.min_delta
        else:
            improved = score < self.best_score - self.min_delta
        if improved:
            self.best_score = score
            self.best_epoch = epoch
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop


def _nested_metrics_from_row(row: dict) -> dict:
    """Invert a flat epoch-CSV row into the ``{"train": {...}, "val": {...}}``
    shape ``train_stage`` tracks for the best epoch (resume replay)."""
    train: dict = {}
    val: dict = {}
    for k, v in row.items():
        if k.startswith("train_"):
            train[k[len("train_"):]] = float(v)
        elif k.startswith("val_"):
            val[k[len("val_"):]] = float(v)
    return {"train": train, "val": val}


def _epoch_row(epoch: int, train_results: dict, val_results: dict) -> dict:
    return {
        "epoch": epoch,
        "train_loss": train_results["loss"],
        "train_dice_loss": train_results.get("dice_loss", 0.0),
        "train_bce_loss": train_results.get("bce_loss", 0.0),
        "train_pde_loss": train_results.get("pde_loss", 0.0),
        "train_phase_field_loss": train_results.get("phase_field_loss", 0.0),
        "train_dice_score": train_results.get("dice_score", 0.0),
        "train_iou_score": train_results.get("iou_score", 0.0),
        "train_boundary_f1_score": train_results.get("boundary_f1_score", 0.0),
        "val_loss": val_results["loss"],
        "val_dice_score": val_results["dice_score"],
        "val_dice_loss": val_results.get("dice_loss", 0.0),
        "val_bce_loss": val_results.get("bce_loss", 0.0),
        "val_pde_loss": val_results.get("pde_loss", 0.0),
        "val_phase_field_loss": val_results.get("phase_field_loss", 0.0),
        "val_iou_score": val_results.get("iou_score", 0.0),
        "val_boundary_f1_score": val_results.get("boundary_f1_score", 0.0),
    }


def train_stage(
    state: TrainState,
    train_epoch_fn,
    eval_epoch_fn,
    train_data,
    val_data,
    *,
    batch_size: int,
    num_epochs: int,
    stage_name: str,
    shuffle_seed: int,
    early_stopping: Optional[EarlyStopping] = None,
    verbose: bool = True,
    csv_path=None,
    epoch_callback=None,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    checkpoint_keep: Optional[int] = 2,
    timing_out: Optional[dict] = None,
    save_best_path=None,
    initial_metrics: Optional[list[dict]] = None,
) -> tuple[TrainState, dict, int, list[dict]]:
    """Host-side stage loop.  Returns
    ``(state, best_metrics, best_epoch, all_epoch_metrics)``; the state is
    the LAST epoch's.

    Epoch ``e`` (from 0) shuffles with a CPU generator seeded by
    ``fold_seed(shuffle_seed, e)``.

    ``checkpoint_dir``/``checkpoint_every``: save the full train state
    (:func:`.checkpoint.save_train_state`) every N epochs and at the last
    one; ``checkpoint_keep`` bounds retention to the newest N (``None``
    keeps all; a state is ~250 MB at base_channels 64).

    ``initial_metrics``: rows of epochs an interrupted run completed, with
    ``state`` restored to match.  They are replayed through the same
    best-epoch tracking and early stopping, then training continues at
    epoch ``len(initial_metrics)``.  A resumed stage is bit-identical to
    an uninterrupted one.

    ``save_best_path``: when set, the parameters of every new best
    validation-Dice epoch are saved there (``.pth``); the returned state
    stays the last epoch's.  ``epoch_callback(epoch, row)`` runs after
    each epoch's row and checkpoint are written.

    ``timing_out``, when given, receives ``epoch_seconds`` and
    ``steady_state_images_per_sec`` (first epoch excluded: it includes
    cuDNN's algorithm search and the kernels' first build).

    Crash hook for tests of resume: with ``PIIS_FAULT_AFTER="<stage_name>:<epoch>"``
    in the environment, ``RuntimeError`` is raised right after that epoch
    of that stage, once its CSV row and any checkpoint are written.
    """
    from ..data.pipeline import epoch_batch_indices, fold_seed
    from .checkpoint import save_params, save_train_state
    from .csvlog import save_metrics_to_csv

    best_val_dice = 0.0
    best_epoch = 0
    best_metrics: dict = {}
    all_metrics: list[dict] = []
    epoch_seconds: list[float] = []
    device = train_data.device

    if initial_metrics:
        all_metrics = [dict(r) for r in initial_metrics]
        for row in all_metrics:
            vd, ep = float(row["val_dice_score"]), int(row["epoch"])
            if vd > best_val_dice:
                best_val_dice = vd
                best_epoch = ep
                best_metrics = _nested_metrics_from_row(row)
            if early_stopping is not None and early_stopping(vd, ep):
                # the interrupted run had already stopped
                if verbose:
                    print(f"\n[resume] {stage_name}: early stopping already "
                          f"triggered at epoch {ep} in the previous run")
                if csv_path is not None:
                    save_metrics_to_csv(all_metrics, csv_path)
                if timing_out is not None:
                    timing_out["epoch_seconds"] = []
                    timing_out["steady_state_images_per_sec"] = 0.0
                return state, best_metrics, best_epoch, all_metrics
        if verbose:
            print(f"[resume] {stage_name}: {len(all_metrics)} completed epoch(s) "
                  f"replayed, continuing at epoch {len(all_metrics) + 1}/{num_epochs}")

    with span("piis.plan"):
        val_idx, val_valid = epoch_batch_indices(val_data.n, batch_size, shuffle=False,
                                                 device=device)

    for epoch in range(len(all_metrics), num_epochs):
        with span("piis.epoch"):
            t_epoch = time.perf_counter()
            with span("piis.plan"):
                shuffle = torch.Generator().manual_seed(fold_seed(shuffle_seed, epoch))
                idx, valid = epoch_batch_indices(
                    train_data.n, batch_size, shuffle=True, generator=shuffle, device=device
                )
            state, train_results = train_epoch_fn(
                state, train_data.images, train_data.masks, idx, valid
            )
            with span("piis.val"):
                val_results = eval_epoch_fn(
                    state.model, val_data.images, val_data.masks, val_idx, val_valid
                )
            epoch_seconds.append(time.perf_counter() - t_epoch)

            with span("piis.log"):
                if val_results["dice_score"] > best_val_dice:
                    best_val_dice = val_results["dice_score"]
                    best_epoch = epoch + 1
                    best_metrics = {"train": train_results, "val": val_results}
                    if save_best_path is not None:
                        save_params(state.model, save_best_path)

                epoch_metrics = _epoch_row(epoch + 1, train_results, val_results)
                all_metrics.append(epoch_metrics)
                if csv_path is not None:
                    save_metrics_to_csv(all_metrics, csv_path)
                if checkpoint_dir is not None and checkpoint_every > 0:
                    if (epoch + 1) % checkpoint_every == 0 or epoch + 1 == num_epochs:
                        save_train_state(state, checkpoint_dir, keep=checkpoint_keep)
                if epoch_callback is not None:
                    epoch_callback(epoch + 1, epoch_metrics)

                fault = os.environ.get("PIIS_FAULT_AFTER")
                if fault is not None:
                    f_stage, _, f_epoch = fault.rpartition(":")
                    if f_stage == stage_name and int(f_epoch) == epoch + 1:
                        raise RuntimeError(f"PIIS_FAULT_AFTER: injected crash after "
                                           f"{stage_name} epoch {epoch + 1}")

                if verbose:
                    print(f"\n{stage_name} - Epoch {epoch + 1}/{num_epochs}")
                    print(f"  Train Loss: {train_results['loss']:.6f}")
                    print(f"    - Dice Loss: {train_results['dice_loss']:.6f}")
                    print(f"    - BCE Loss: {train_results['bce_loss']:.6f}")
                    if train_results.get("pde_loss", 0.0) != 0.0:
                        print(f"    - PDE Loss: {train_results['pde_loss']:.6f}")
                    print(f"  Val Loss: {val_results['loss']:.6f}")
                    print(f"  Val Dice Score: {val_results['dice_score']:.6f}")

                score = val_results["dice_score"]
                if early_stopping is not None and early_stopping(score, epoch + 1):
                    if verbose:
                        print(f"\nEarly stopping triggered at epoch {epoch + 1}")
                        print(f"Best validation Dice score: {best_val_dice:.6f} "
                              f"at epoch {best_epoch}")
                    break

    if timing_out is not None:
        steady = epoch_seconds[1:] if len(epoch_seconds) > 1 else epoch_seconds
        timing_out["epoch_seconds"] = epoch_seconds
        timing_out["steady_state_images_per_sec"] = (
            train_data.n / (sum(steady) / len(steady)) if steady else 0.0
        )
    return state, best_metrics, best_epoch, all_metrics
