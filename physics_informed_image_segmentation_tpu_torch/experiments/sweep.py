"""Batched sensitivity sweeps: a whole S1/S2/S3 grid trained as one stack.

Counterpart of ``physics_informed_image_segmentation_tpu/experiments/sweep.py``,
with the same names, arguments and artifacts (``.pth`` where the JAX
package writes ``.msgpack``).  The members of a sensitivity grid differ only
in scalar loss hyper-parameters (a, D, ε, λ_RD, λ_PF), so:

* Stage I (Dice+BCE) is the same for every member (same seed, data subset
  and loss): it trains once, through :func:`..train.engine.train_stage`, and
  its weights start every member.
* Stage II trains all members together.  Their parameters are stacked
  along a leading member axis and the U-Net runs once a step under
  ``torch.func.vmap`` (the image batch is shared; a convolution over
  stacked weights becomes a grouped one).  The prediction leaves ``vmap``
  as (M, B, H, W, 1); each member's loss is computed on its slice with
  its own scalars, so the physics kernel K1 (an ``autograd.Function``,
  which has no vmap rule) launches once a member each way; one backward
  of the summed losses gives each member exactly its own gradient, since
  members share no parameter.
* Early stopping is kept per member, as the serial runner keeps it; from
  the epoch after a member stops, its parameters and moments are frozen.
  The stack keeps its shape until every member has stopped.

Seeds follow the port's serial variant runner
(:func:`.ablation.run_ablation_variant`), so that member m of a batched
study is serial variant m up to the rounding of a grouped convolution:
the init from ``fold_seed(seed, 0)``, Stage I with dropout seed ``seed + 1``
and shuffles ``fold_seed(seed, 1)``, Stage II with ``seed + 2`` and
``fold_seed(seed, 2)``.  By default all members share one dropout stream,
as every serial variant draws the same one; the masks are drawn outside
``vmap`` (:func:`..models.unet.draw_dropout_masks`), from one generator or
from one per member (``member_seeds``).

The physics is computed over (H, W), as on every path of the port.  (The
JAX sweep's member loss stencils the last two axes of its (B, H, W, 1)
prediction, i.e. (W, C); ROADMAP queue 3.)
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call, vmap

from ..data import DeviceDataset, epoch_batch_indices, fold_seed, subset_fraction_indices
from ..models import UNet, require_unet
from ..models.unet import draw_dropout_masks
from ..ops import metrics as M
from ..ops.physics_kernel import fused_loss_components
from ..train.checkpoint import load_params, save_params
from ..train.csvlog import save_metrics_to_csv
from ..train.engine import (
    _LOSS_KEYS,
    EarlyStopping,
    create_train_state,
    make_eval_epoch_fn,
    make_train_epoch_fn,
    train_stage,
)
from ..train.loop import load_device_dataset
from ..train.objective import LossConfig
from ..train.optim import AdamW
from ..utils.device import autocast, resolve_device, set_precision
from .ablation import AblationConfig, _compare_both, _eval_both, _snake, _write_study_files

__all__ = ["run_batched_sweep", "run_batched_study", "sweep_scalars_from_variants"]

_SCORE_KEYS = ("dice_score", "iou_score", "boundary_f1_score")
_SCALAR_KEYS = ("pde_weight", "phase_field_weight", "diffusion_coeff", "reaction_threshold",
                "epsilon")


def sweep_scalars_from_variants(variants: List[AblationConfig]) -> Dict[str, np.ndarray]:
    """Stack each variant's scalar loss hyper-parameters into (M,) arrays."""
    return {k: np.asarray([getattr(v, k) for v in variants], np.float32) for k in _SCALAR_KEYS}


def _member_loss(pred, y, mask, sc: Dict[str, float], backend: str = "auto"):
    """Dice+BCE + λ_RD·rd + λ_PF·pf of one member, with its own scalars.

    The weights multiply unconditionally, and ``pde_loss`` and
    ``phase_field_loss`` are reported whatever their weight.  The physics
    sums are K1's on CUDA tensors (``backend`` "auto" or "cuda") and its
    plain version on the CPU or with ``backend="torch"``.
    """
    if backend == "cuda" and not pred.is_cuda:
        raise ValueError(f"backend='cuda' needs CUDA tensors; got a tensor on {pred.device}")
    comps = fused_loss_components(
        pred, y, diffusion_coeff=sc["diffusion_coeff"],
        reaction_threshold=sc["reaction_threshold"], epsilon=sc["epsilon"], mask=mask,
        plain=backend == "torch",
    )
    total = (0.5 * comps["dice_loss"] + 0.5 * comps["bce_loss"]
             + sc["pde_weight"] * comps["pde_loss"]
             + sc["phase_field_weight"] * comps["phase_field_loss"])
    return total, comps


def _stack_params(model: torch.nn.Module, init_params: Mapping, m_count: int, device):
    """The model's (deduplicated) parameter names and their (M, ...) float32
    leaves.  ``init_params`` is a state dict: one model's (copied to every
    member) or a stacked one (each tensor with a leading member axis)."""
    names, shapes = zip(*((n, p.shape) for n, p in model.named_parameters()))
    stacked = all(tuple(init_params[n].shape) == (m_count, *s) for n, s in zip(names, shapes))
    leaves = []
    for n, s in zip(names, shapes):
        t = torch.as_tensor(init_params[n]).to(device, torch.float32)
        t = t.clone() if stacked else t.expand(m_count, *s).clone()
        leaves.append(t.requires_grad_())
    return list(names), leaves


def run_batched_sweep(
    model: UNet,
    init_params: Mapping,
    scalars: Dict[str, np.ndarray],
    train_data: DeviceDataset,
    val_data: DeviceDataset,
    *,
    num_epochs: int,
    batch_size: int,
    learning_rate: float,
    early_stopping_patience: int = 10,
    min_delta: float = 1e-4,
    shuffle_seed: Optional[int] = None,
    seed: int = 42,
    member_seeds: Optional[np.ndarray] = None,
    precision: str = "f32",
    physics_backend: str = "auto",
    device=None,
) -> Dict:
    """Train M grid members together from ``init_params`` on ``device``
    (CUDA unless ``"cpu"``).

    ``model`` gives the architecture (its own parameters are not used or
    changed, but it is moved to ``device``).  ``init_params``: a state dict,
    one model's (every member starts from it: the sensitivity-sweep case)
    or stacked with a leading member axis (multi-seed replication).
    ``scalars``: (M,) arrays of :func:`sweep_scalars_from_variants`.

    Dropout draws from one generator seeded with ``seed``, shared by all
    members, or from one per member seeded with ``member_seeds[m]``: member
    m then draws as a serial run with ``dropout_seed=member_seeds[m]``.
    Epoch e shuffles with ``fold_seed(shuffle_seed, e)`` (default
    ``shuffle_seed``: ``seed + 1``), as :func:`..train.engine.train_stage`
    does.  The optimizer is the port's AdamW (weight decay 1e-5) over the
    stacked tensors; all active members share its step count.

    Returns ``params`` (a state dict of (M, ...) tensors), ``stop_epoch``
    and ``best_val_dice`` (M,), and ``history``: (E, M) arrays of ``active``
    and the ``train_*``/``val_*`` columns of the epoch CSV, where E is the
    number of epochs run (the loop ends once every member has stopped).
    """
    require_unet(model, "the batched sweep")
    if physics_backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown physics_backend {physics_backend!r}")
    device = resolve_device(device)
    precision = set_precision(precision)
    train_data, val_data = train_data.to(device), val_data.to(device)
    m_count = len(next(iter(scalars.values())))
    member_sc = [{k: float(scalars[k][i]) for k in _SCALAR_KEYS} for i in range(m_count)]
    model = model.to(device)
    names, params = _stack_params(model, init_params, m_count, device)
    opt = AdamW(params, learning_rate, 1e-5)
    tensors = params + opt.m + opt.v

    if member_seeds is None:
        generators = [torch.Generator(device=device).manual_seed(seed)]
    else:
        generators = [torch.Generator(device=device).manual_seed(int(s)) for s in member_seeds]
    if shuffle_seed is None:
        shuffle_seed = seed + 1

    def forward(p, x, keep):
        out = functional_call(model, dict(zip(names, p)), (x.permute(0, 3, 1, 2),),
                              {"dropout_masks": keep})
        return out.permute(0, 2, 3, 1)

    def stacked_forward(x, keep=None, keep_dim=None):
        with autocast(device, precision):
            return vmap(forward, in_dims=(0, None, keep_dim))(params, x, keep or {})

    def dropout_masks(b):
        """Masks of one training step, and their vmap axis."""
        if len(generators) == 1:
            return draw_dropout_masks(model, b, generators[0], device), None
        draws = [draw_dropout_masks(model, b, g, device) for g in generators]
        return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}, 0

    def member_losses(pred, y, valid):
        mask = valid.reshape(-1, 1, 1, 1)
        outs = [_member_loss(pred[i], y, mask, member_sc[i], physics_backend)
                for i in range(m_count)]
        totals = torch.stack([t for t, _ in outs])
        comps = torch.stack([torch.stack([c[k] for k in _LOSS_KEYS[1:]]) for _, c in outs], 1)
        return totals, comps  # (M,), (4, M)

    def member_score_sums(pred, y, valid):
        """(3, M) sums over valid samples of per-sample Dice, IoU and
        boundary F1, computed on the folded (M·B) batch."""
        b, h, w = y.shape[:3]
        p2 = pred.detach()[..., 0].reshape(m_count * b, h, w)
        t2 = y[..., 0].repeat(m_count, 1, 1)
        per = torch.stack([M.dice_score_per_sample(p2, t2), M.iou_score_per_sample(p2, t2),
                           M.boundary_f1_per_sample(p2, t2)])
        return (per.view(3, m_count, b) * valid).sum(-1)

    frozen = None  # (member indices, their tensors) of the stopped members

    def train_epoch(idx, valid):
        model.train()
        rows = []
        for b in range(idx.shape[0]):
            x, y, v = train_data.images[idx[b]], train_data.masks[idx[b]], valid[b]
            keep, keep_dim = dropout_masks(x.shape[0])
            pred = stacked_forward(x, keep, keep_dim)
            totals, comps = member_losses(pred, y, v)
            grads = torch.autograd.grad(totals.sum(), params)
            opt.step(grads)
            if frozen is not None:
                with torch.no_grad():
                    for t, kept in zip(tensors, frozen[1]):
                        t.index_copy_(0, frozen[0], kept)
            rows.append(torch.cat([totals.detach()[None], comps.detach(),
                                   member_score_sums(pred, y, v), v.sum().expand(1, m_count)]))
        cols = torch.stack(rows).cpu().double()  # (nb, 9, M)
        out = dict(zip(_LOSS_KEYS, cols[:, :5].mean(0).numpy()))
        out.update(zip(_SCORE_KEYS, (cols[:, 5:8].sum(0) / cols[:, 8].sum(0)).numpy()))
        return out

    val_idx, val_valid = epoch_batch_indices(val_data.n, batch_size, shuffle=False,
                                             device=device)

    @torch.no_grad()
    def val_epoch():
        model.eval()
        rows = []
        for b in range(val_idx.shape[0]):
            x, y, v = val_data.images[val_idx[b]], val_data.masks[val_idx[b]], val_valid[b]
            pred = stacked_forward(x)
            totals, comps = member_losses(pred, y, v)
            m2 = v.reshape(-1, 1, 1)
            global_dice = torch.stack([M.dice_score(pred[i][..., 0], y[..., 0], mask=m2)
                                       for i in range(m_count)])
            rows.append(torch.cat([totals[None], comps, global_dice[None],
                                   member_score_sums(pred, y, v), v.sum().expand(1, m_count)]))
        cols = torch.stack(rows).cpu().double()  # (nb, 10, M)
        out = dict(zip(_LOSS_KEYS, cols[:, :5].mean(0).numpy()))
        out["dice_score"] = cols[:, 5].mean(0).numpy()
        out.update(zip(_SCORE_KEYS[1:], (cols[:, 7:9].sum(0) / cols[:, 9].sum(0)).numpy()))
        return out

    stoppers = [EarlyStopping(early_stopping_patience, min_delta, "max") for _ in range(m_count)]
    stop_epoch = np.full(m_count, num_epochs, np.int64)
    stopped = np.zeros(m_count, bool)
    history: Dict[str, list] = {}
    for epoch in range(num_epochs):
        shuffle = torch.Generator().manual_seed(fold_seed(shuffle_seed, epoch))
        idx, valid = epoch_batch_indices(train_data.n, batch_size, shuffle=True,
                                         generator=shuffle, device=device)
        train_res = train_epoch(idx, valid)
        val_res = val_epoch()
        history.setdefault("active", []).append(~stopped)
        for prefix, res in (("train", train_res), ("val", val_res)):
            for k in (*_LOSS_KEYS, *_SCORE_KEYS):
                history.setdefault(f"{prefix}_{k}", []).append(res[k])
        newly = [i for i in range(m_count)
                 if not stopped[i] and stoppers[i](float(val_res["dice_score"][i]), epoch + 1)]
        if newly:
            stopped[newly] = True
            stop_epoch[newly] = epoch + 1
            which = torch.as_tensor(np.flatnonzero(stopped), device=device)
            frozen = (which, [t.detach().index_select(0, which) for t in tensors])
        if stopped.all():
            break

    index = {id(p): i for i, p in enumerate(model.parameters())}
    return {
        "params": {n: params[index[id(p)]].detach()
                   for n, p in model.named_parameters(remove_duplicate=False)},
        "stop_epoch": stop_epoch,
        "best_val_dice": np.asarray([s.best_score for s in stoppers], np.float64),
        "history": {k: np.stack(v) for k, v in history.items()},  # (E, M)
    }


def _member_epoch_rows(history: Dict[str, np.ndarray], member: int, stop_epoch: int):
    """17-column CSV rows for one member, truncated at its stop epoch."""
    rows = []
    for e in range(stop_epoch):
        row = {"epoch": e + 1}
        for prefix in ("train", "val"):
            for k in (*_LOSS_KEYS, *_SCORE_KEYS):
                key = f"{prefix}_{k}"
                if key in history:
                    row[key] = float(history[key][e, member])
        rows.append(row)
    return rows


def run_batched_study(
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
    """Run a sensitivity study (S1/S2/S3-shaped) with its Stage II batched,
    on ``device`` (CUDA unless ``"cpu"``).

    Writes the artifact layout of :func:`.ablation.run_ablation_study`
    (results JSON, summary CSVs, per-member stage CSVs and model files)
    plus the shared Stage I's ``shared_stage1_metrics.csv`` and
    ``shared_baseline_after_stage1.pth``, with ``"batched": true`` in the
    results JSON.

    ``resume_from``: an interrupted batched run's ``{name}_{timestamp}``
    folder.  If it holds ``shared_baseline_after_stage1.pth``, the shared
    Stage I is loaded from it instead of retrained; Stage II restarts from
    that state.
    """
    # sweepability: members may differ only in scalar loss params
    base = variants[0]
    for v in variants:
        if (
            v.seed != base.seed
            or v.train_fraction != base.train_fraction
            or not v.use_two_stage
            or not v.use_pde
            or v.use_three_stage
            or not v.use_reaction_term
            or v.output_activation != base.output_activation
            or v.intermediate_activation != base.intermediate_activation
        ):
            raise ValueError(
                f"variant {v.name} is not batchable with {base.name}; "
                "use run_ablation_study for heterogeneous grids"
            )

    device = resolve_device(device)
    precision = set_precision(precision)
    results_root = (
        Path(output_dir) if output_dir is not None else Path.cwd() / "output" / "ablation"
    )
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    stage1_ckpt = None
    if resume_from is not None:
        ablation_folder = Path(resume_from)
        if not ablation_folder.is_dir():
            raise FileNotFoundError(f"resume_from folder not found: {ablation_folder}")
        prefix = f"{ablation_name}_"
        if ablation_folder.name.startswith(prefix):
            # keep the interrupted run's timestamp in artifact names
            timestamp = ablation_folder.name[len(prefix):]
        candidate = ablation_folder / "shared_baseline_after_stage1.pth"
        if candidate.exists():
            stage1_ckpt = candidate
    else:
        ablation_folder = results_root / f"{ablation_name}_{timestamp}"
    ablation_folder.mkdir(parents=True, exist_ok=True)

    print("=" * 70)
    print(f"BATCHED ABLATION STUDY: {ablation_name} ({len(variants)} members, one stack)")
    print("=" * 70)

    if datasets is None:
        datasets = {
            "train": load_device_dataset(train_dir, train_json, device),
            "val": load_device_dataset(val_dir, val_json, device),
            "in_dist": load_device_dataset(in_dist_test_dir, in_dist_test_json, device),
            "out_dist": load_device_dataset(out_dist_test_dir, out_dist_test_json, device),
        }
    else:
        datasets = {k: d.to(device) for k, d in datasets.items()}

    np.random.seed(base.seed)
    train_data, val_data = datasets["train"], datasets["val"]
    if base.train_fraction is not None:
        train_data = train_data.select(
            subset_fraction_indices(train_data.n, base.train_fraction)
        )

    model = UNet(
        in_channels=1,
        out_channels=1,
        base_channels=base_channels,
        output_activation=base.output_activation,
        intermediate_activation=base.intermediate_activation,
        param_init=base.param_init,
        generator=torch.Generator().manual_seed(fold_seed(base.seed, 0)),
    ).to(device)

    # ------------------------------------------------ Stage I (shared)
    if stage1_ckpt is not None:
        print(f"\nStage I: loading shared baseline from {stage1_ckpt.name} (resume)")
        load_params(stage1_ckpt, model)
    else:
        print("\nStage I: Baseline Training (shared across all members)")
        dicebce = LossConfig(backend=physics_backend)
        train_stage(
            create_train_state(model, learning_rate, dropout_seed=base.seed + 1),
            make_train_epoch_fn(dicebce, precision=precision),
            make_eval_epoch_fn(dicebce, precision=precision),
            train_data,
            val_data,
            batch_size=batch_size,
            num_epochs=stage1_epochs,
            stage_name="Stage I",
            shuffle_seed=fold_seed(base.seed, 1),
            early_stopping=EarlyStopping(early_stopping_patience, 1e-4, "max"),
            verbose=False,
            csv_path=ablation_folder / "shared_stage1_metrics.csv",
        )
        save_params(model, ablation_folder / "shared_baseline_after_stage1.pth")
    baseline_metrics = _eval_both(model, datasets["in_dist"], datasets["out_dist"], batch_size,
                                  precision)

    # --------------------------------------------- Stage II (batched)
    print(f"\nStage II: batched PDE fine-tuning of {len(variants)} members")
    sweep = run_batched_sweep(
        model,
        model.state_dict(),
        sweep_scalars_from_variants(variants),
        train_data,
        val_data,
        num_epochs=stage2_epochs,
        batch_size=batch_size,
        learning_rate=learning_rate,
        early_stopping_patience=early_stopping_patience,
        shuffle_seed=fold_seed(base.seed, 2),
        seed=base.seed + 2,
        precision=precision,
        physics_backend=physics_backend,
        device=device,
    )

    # ------------------------------------- per-member artifacts + eval
    all_results = []
    for i, variant in enumerate(variants):
        stem = _snake(variant.name)
        model.load_state_dict({k: v[i] for k, v in sweep["params"].items()})
        model_path = save_params(model, ablation_folder / f"{stem}_after_pde_stage2.pth")
        stop = int(sweep["stop_epoch"][i])
        save_metrics_to_csv(_member_epoch_rows(sweep["history"], i, stop),
                            ablation_folder / f"{stem}_stage2_metrics.csv")
        member_metrics = _eval_both(model, datasets["in_dist"], datasets["out_dist"],
                                    batch_size, precision)
        comparison = _compare_both(baseline_metrics, member_metrics)
        result = {
            "config": variant.to_dict(),
            "model_path": str(model_path),
            "stop_epoch": stop,
            "best_val_dice": float(sweep["best_val_dice"][i]),
            "in_dist_metrics": {
                k: np.asarray(v).tolist() for k, v in member_metrics["in_dist"].items()
            },
            "out_dist_metrics": {
                k: np.asarray(v).tolist() for k, v in member_metrics["out_dist"].items()
            },
            "metrics": {
                k: np.asarray(v).tolist() for k, v in member_metrics["in_dist"].items()
            },
            "stage_comparison": {
                d: {
                    k: {
                        kk: (bool(vv) if kk == "significant" else float(vv))
                        for kk, vv in r.items()
                    }
                    for k, r in comparison[d].items()
                }
                for d in ("in_dist", "out_dist")
            },
        }
        all_results.append(result)
        print(
            f"  {variant.name}: stop_epoch={stop}, "
            f"best val dice={float(sweep['best_val_dice'][i]):.4f}, "
            f"test dice={np.nanmean(result['in_dist_metrics']['dice_scores']):.4f}"
        )

    results_json, summaries, aggregated_in, _ = _write_study_files(
        ablation_folder, ablation_name, timestamp, variants, all_results, batched=True)

    print(f"\nBatched study complete. All files in: {ablation_folder}")
    return {
        "ablation_name": ablation_name,
        "results_json": str(results_json),
        "summary_csv": str(summaries[""]),
        "aggregated_results": aggregated_in,
        "ablation_folder": str(ablation_folder),
        "stop_epochs": sweep["stop_epoch"].tolist(),
    }
