"""Space-sharded epochs held against the unsharded epochs on the same plan.

    python -m physics_informed_image_segmentation_tpu_torch.parallel.launch 4 \
        physics_informed_image_segmentation_tpu_torch.parallel.spatial_check --data 2
    python -m physics_informed_image_segmentation_tpu_torch.parallel.spatial_check

Every rank runs :func:`..train.engine.train_stage` twice from the same
seeded weights and plans, in float32 with dropout 0 and deterministic
cuDNN: once with :func:`.sharding.make_sharded_epoch_fns` ``(spatial=True)``
on a ``(data, space)`` mesh over all ranks (the physics through K3 on the
GPU), and once alone with the unsharded epoch functions (K1 on the GPU).
It prints one JSON line a rank and exits 1 if a bar is missed: loss
columns rtol 1e-4, IoU and Boundary-F1 atol 1e-6, Dice atol 1e-5, and
parameters within 5% of their own movement over the stage (one epoch of
two steps and a validation batch by default; ``--epochs``).  Beside them
it prints the first batch's gradient, sharded against whole, tensor by
tensor (``grad_ok``: relative L2 within 1e-4), which AdamW's rounding does
not reach, with references that tell rounding from fault (see
:func:`_first_step_gradients`).  Alone it runs as a world of one; it runs
on the GPU (NCCL) unless given ``--device cpu`` (gloo).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch
import torch.distributed as dist

from ..data import DeviceDataset, make_blobs
from ..models import UNet
from ..train.engine import (
    create_train_state, forward_nhwc, make_eval_epoch_fn, make_train_epoch_fn, train_stage,
)
from ..train.objective import LossConfig, make_loss_and_components
from ..utils.device import card_line, set_precision
from .mesh import initialize_distributed, make_mesh
from .sharding import MeshShard, make_sharded_epoch_fns, shard_train_state

__all__ = ["run", "main", "param_gap", "LOSS_RTOL", "SCORE_ATOL", "DICE_ATOL", "PARAM_REL", "GRAD_REL"]

STAGE2 = LossConfig(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0)
LOSS_RTOL, SCORE_ATOL, DICE_ATOL, PARAM_REL = 1e-4, 1e-6, 1e-5, 5e-2
# the first step's gradient, tensor by tensor: float32 sums in other orders
# (band convolutions, all-reduces) against a wrong layer gradient's ~1
GRAD_REL = 1e-4
_LOSSES = ("loss", "dice_loss", "bce_loss", "pde_loss", "phase_field_loss")


def _rel_l2(grads, ref, names) -> list:
    """``(relative L2 difference, name)`` of every tensor, largest first."""
    return sorted(((float((a - b).norm() / b.norm()), n) for a, b, n in zip(grads, ref, names)),
                  reverse=True)


def _digest(grads) -> float:
    """Σ|g| in float64 over every tensor: equal on two devices that compute
    the same gradient bit for bit."""
    return float(sum(g.double().abs().sum() for g in grads))


def _gathered_sum(partials) -> list:
    """Every rank's tensors gathered (a copy, exact) and summed in float64."""
    flat = torch.cat([g.reshape(-1) for g in partials])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    total = torch.stack(parts).double().sum(0)
    out, off = [], 0
    for g in partials:
        out.append(total[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return out


def _first_step_gradients(model_fn, mesh, x, y, valid, cfg) -> dict:
    """The largest relative L2 difference, tensor by tensor, between the
    global gradient of one batch taken whole and (a) taken sharded (this
    rank's block, summed over the ranks), (b) taken whole with the forward
    run in two halves of the batch, one sample at a time, and (with one
    band a sample) one sample at a time through the band path's forward,
    its zero halo rows: (b) is the rounding that a smaller batch alone
    brings (the convolutions' algorithms depend on it).  And
    (c): the gradient all-reduce of (a) against the float64 sum of the
    ranks' gathered partial gradients, the collective's own error."""
    mask = valid.reshape(-1, 1, 1, 1)
    plain = model_fn()
    names = [n for n, _ in plain.named_parameters()]
    loss = make_loss_and_components(cfg)
    g_p = torch.autograd.grad(loss(forward_nhwc(plain, x, "f32"), y, mask)[0],
                              list(plain.parameters()))
    shard = MeshShard(mesh, spatial=True)
    split = {}
    # the band path on whole images needs bands that are whole images
    band_path = [("sharded", shard.forward)] if mesh.space == 1 else []
    for parts, forward in ((2, forward_nhwc), (x.shape[0], forward_nhwc), *band_path):
        model = model_fn()
        chunks = x.chunk(x.shape[0] if parts == "sharded" else parts)
        pred = torch.cat([forward(model, xs, "f32") for xs in chunks])
        split[parts] = _rel_l2(torch.autograd.grad(loss(pred, y, mask)[0],
                                                   list(model.parameters())), g_p, names)
    sharded = model_fn()
    pred = shard.forward(sharded, shard.local(x), "f32")
    v = shard.local(valid)
    total = shard.loss_fn(cfg)(pred, shard.local(y), v.reshape(-1, 1, 1, 1))[0]
    partials = torch.autograd.grad(total, list(sharded.parameters()))
    exact = _gathered_sum(partials)
    g_s = shard.reduce_grads(partials)
    sharded_rel, reduce_rel = _rel_l2(g_s, g_p, names), _rel_l2(g_s, exact, names)
    return {"first_step_grad_max_rel_l2": sharded_rel[0][0],
            "first_step_grad_worst": sharded_rel[0][1], "first_step_grad_top": sharded_rel[:4],
            "halves_grad_max_rel_l2": split[2][0][0], "halves_grad_worst": split[2][0][1],
            "per_sample_grad_max_rel_l2": split[x.shape[0]][0][0],
            "per_sample_grad_worst": split[x.shape[0]][0][1],
            "per_sample_band_path_grad_max_rel_l2": split["sharded"][0][0] if band_path else None,
            "per_sample_band_path_grad_worst": split["sharded"][0][1] if band_path else None,
            "all_reduce_max_rel_l2": reduce_rel[0][0], "all_reduce_worst": reduce_rel[0][1],
            "whole_grad_digest": _digest(g_p), "local_grad_digest": _digest(partials),
            "grad_ok": sharded_rel[0][0] <= GRAD_REL}


def _stage(model, fns, train, val, batch, epochs, mesh=None):
    state = create_train_state(model, 1e-4)
    if mesh is not None:
        state = shard_train_state(state, mesh)
    _, _, _, rows = train_stage(state, *fns, train, val, batch_size=batch, num_epochs=epochs,
                                stage_name="spatial check", shuffle_seed=0, verbose=False)
    return rows


def run(size: int = 64, base_channels: int = 4, data: int = 1, *, batch: int = 4,
        n_train: int = 6, n_val: int = 3, epochs: int = 1, cudnn: bool = True,
        physics_backend: str = "auto") -> dict:
    """Both stages on ``size``² ``make_blobs`` images; call
    :func:`.mesh.initialize_distributed` first.  ``data`` ranks shard the
    batch, the others (world / data) image height.  Returns this rank's
    largest differences (and each epoch's), the parameters' largest
    difference against their largest movement and the ratio of their L2
    norms, and ``ok`` (the bars over every epoch); and, before the stages,
    the first batch's gradient taken sharded against taken whole
    (``grad_ok``: every tensor within ``GRAD_REL`` relative L2), beside
    the same with only the forward split in two halves of the batch.
    ``cudnn=False`` runs the convolutions on PyTorch's own CUDA kernels, to
    tell the rounding of cuDNN's algorithms (they change with the shapes a
    rank sees) from a fault of the sharded path; ``physics_backend="torch"``
    takes the plain physics on both sides instead of K3 and K1.

    The bars are set for one epoch.  Over more steps AdamW's g/√v turns
    rounding into a share of the learning rate wherever a gradient is near
    0, so the largest parameter difference grows towards the movement
    itself while the L2 ratio stays small."""
    mesh = make_mesh(data=data, space=dist.get_world_size() // data)
    dev = mesh.device
    set_precision("f32")
    if dev.type == "cuda":
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.backends.cudnn.enabled = cudnn
    images, masks = make_blobs(n_train + n_val, size, size, seed=1)
    train = DeviceDataset.from_numpy(images[:n_train], masks[:n_train], dev)
    val = DeviceDataset.from_numpy(images[n_train:], masks[n_train:], dev)

    def fresh():
        return UNet(base_channels=base_channels, dropout=0.0,
                    generator=torch.Generator().manual_seed(0)).to(dev)

    valid = torch.ones(batch, device=dev)
    valid[-1] = 0.0
    cfg = dataclasses.replace(STAGE2, backend=physics_backend)
    grads = _first_step_gradients(fresh, mesh, train.images[:batch], train.masks[:batch], valid,
                                  cfg)
    start = [p.detach().clone() for p in fresh().parameters()]
    sharded, plain = fresh(), fresh()
    rows_s = _stage(sharded, make_sharded_epoch_fns(cfg, mesh, spatial=True), train, val,
                    batch, epochs, mesh)
    rows_p = _stage(plain, (make_train_epoch_fn(cfg), make_eval_epoch_fn(cfg)), train, val,
                    batch, epochs)

    by_epoch = [_row_diffs(rs, rp) for rs, rp in zip(rows_s, rows_p)]
    loss_rel, score_err, dice_err = (max(d[i] for d in by_epoch) for i in range(3))
    gap, move, l2 = param_gap(sharded, plain, start)
    ok = (loss_rel <= LOSS_RTOL and score_err <= SCORE_ATOL and dice_err <= DICE_ATOL
          and gap <= PARAM_REL * move)
    return {
        "rank": dist.get_rank(), "world": dist.get_world_size(), "mesh": mesh.shape,
        "image": [size, size], "base_channels": base_channels, "batch": batch,
        "epochs": epochs, "cudnn": cudnn, "physics_backend": physics_backend,
        "loss_max_rel_diff": loss_rel, "score_max_abs_diff": score_err,
        "dice_max_abs_diff": dice_err, "by_epoch": by_epoch, "max_abs_dparam": gap,
        "movement": move, "dparam_l2_over_movement_l2": l2,
        **grads,
        "train_loss": [r["train_loss"] for r in rows_s],
        "val_boundary_f1": [r["val_boundary_f1_score"] for r in rows_s], "ok": ok,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


@torch.no_grad()
def param_gap(model, ref, start) -> tuple:
    """``(largest |Δp|, largest movement, L2 ratio)``: ``model``'s parameters
    against ``ref``'s, and ``ref``'s movement from ``start``."""
    gaps = [a - b for a, b in zip(model.parameters(), ref.parameters())]
    moves = [a - b for a, b in zip(ref.parameters(), start)]
    gap = max(float(g.abs().max()) for g in gaps)
    move = max(float(m.abs().max()) for m in moves)
    l2 = float(torch.sqrt(sum((g * g).sum() for g in gaps) / sum((m * m).sum() for m in moves)))
    return gap, move, l2


def _row_diffs(rs: dict, rp: dict) -> tuple:
    """(largest relative loss-column difference, largest IoU/BF1 and Dice
    differences) between two epoch rows."""
    loss_rel, score_err, dice_err = 0.0, 0.0, 0.0
    for k, v in rp.items():
        d = abs(rs[k] - v)
        if k.endswith(_LOSSES):
            loss_rel = max(loss_rel, d / max(abs(v), 1e-30))
        elif k.endswith(("iou_score", "boundary_f1_score")):
            score_err = max(score_err, d)
        elif k.endswith("dice_score"):
            dice_err = max(dice_err, d)
    return loss_rel, score_err, dice_err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=int, default=1, help="ranks on the data axis")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--base-channels", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--no-cudnn", action="store_true",
                    help="convolutions on PyTorch's own CUDA kernels, not cuDNN's")
    ap.add_argument("--physics-backend", default="auto", choices=("auto", "torch"),
                    help="'torch': the plain physics on both sides, not K3 and K1")
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    ap.add_argument("--init-method", default=None,
                    help="a file:// or tcp:// URL, with RANK and WORLD_SIZE in the environment "
                         "(parallel/launch.py passes one)")
    args = ap.parse_args(argv)

    initialize_distributed(args.init_method, device=args.device)
    try:
        res = run(args.size, args.base_channels, args.data, epochs=args.epochs,
                  cudnn=not args.no_cudnn, physics_backend=args.physics_backend)
        if res["device"] != "cpu":
            res["card"] = card_line()
        print(json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
