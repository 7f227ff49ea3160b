"""Plain replays of Stage II epochs of the Swin-Unet (:mod:`.swin_unet`).

:func:`train_steps` is :func:`.steps.train_steps` for the Swin-Unet: for
each batch of an epoch, the forward with stochastic depth, the objective,
its gradients and one AdamW step (:mod:`.adamw`, :mod:`.objective`); at the
epoch's end its row and a validation pass with the updated weights, as the
program's ``train_stage`` does.  The model has no buffers that training
moves.  Float32 with TF32 off, unless ``quant`` names a lower precision
(the controls).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import swin_unet
from .adamw import AdamW
from .objective import batch_metrics, objective
from .steps import no_tf32

__all__ = ["train_steps"]


def _probs(params, x, model, **kw):
    return torch.sigmoid(swin_unet.forward(params, x.permute(0, 3, 1, 2), model, **kw)[:, 0])


def train_steps(params0: dict, epochs: list, val: tuple, model: dict, obj: dict, opt: dict,
                dropout_seed: int, split: int, quant: Optional[str] = None,
                fault: Optional[str] = None) -> dict:
    """As :func:`.steps.train_steps`: the same arguments (``model`` the
    configuration's model group; the drop-path masks drawn from a
    generator seeded with ``dropout_seed``), the same faults, the same
    results."""
    no_tf32()
    device = val[0].device
    params = {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
              for k, v in params0.items()}
    adamw = AdamW(params, opt["learning_rate"], opt["weight_decay"])
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    vb = model["batch_size"]
    rows, first, marks = [], None, []
    tol = 0 if fault == "bf1" else 2
    for batches in epochs:
        if fault == "repeat" and len(batches) > 1:
            batches = [batches[0], batches[0], *batches[2:]]
        losses, pde, pf, dice, iou, bf1 = [], [], [], [], [], []
        for x, t in batches:
            if fault == "half":
                x, t = x[: x.shape[0] // 2], t[: t.shape[0] // 2]
            p = _probs(params, x, model, train=True, drop_path_generator=gen, quant=quant)
            loss, phys = objective(p, t[..., 0], obj)
            grads = torch.autograd.grad(loss, list(params.values()))
            if first is None:
                first = {k: g.detach().cpu() for k, g in zip(params, grads)}
            adamw.step(dict(zip(params, grads)))
            m = batch_metrics(p.detach(), t[..., 0], tol)
            losses.append(float(loss.detach()))
            pde.append(float(phys["pde_loss"].detach()))
            pf.append(float(phys["phase_field_loss"].detach()))
            dice.append(m["dice"])
            iou.append(m["iou"])
            bf1.append(m["bf1"])
        row = {"train_loss": sum(losses) / len(losses),
               "train_pde_loss": sum(pde) / len(pde),
               "train_phase_field_loss": sum(pf) / len(pf),
               "train_dice_score": float(torch.cat(dice).mean()),
               "train_iou_score": float(torch.cat(iou).mean()),
               "train_boundary_f1_score": float(torch.cat(bf1).mean())}
        vloss, vdice, viou, vbf1, vpde, vpf = [], [], [], [], [], []
        with torch.no_grad():
            for i in range(0, val[0].shape[0], vb):
                vx, vt = val[0][i:i + vb], val[1][i:i + vb, ..., 0]
                vp = _probs(params, vx, model, train=False, quant=quant)
                vm = batch_metrics(vp, vt, tol)
                vl, vphys = objective(vp, vt, obj)
                vloss.append(float(vl))
                vpde.append(float(vphys["pde_loss"]))
                vpf.append(float(vphys["phase_field_loss"]))
                vdice.append(float(vm["global_dice"]))
                viou.append(vm["iou"])
                vbf1.append(vm["bf1"])
        row.update(val_loss=sum(vloss) / len(vloss), val_dice_score=sum(vdice) / len(vdice),
                   val_pde_loss=sum(vpde) / len(vpde), val_phase_field_loss=sum(vpf) / len(vpf),
                   val_iou_score=float(torch.cat(viou).mean()),
                   val_boundary_f1_score=float(torch.cat(vbf1).mean()))
        rows.append(row)
        if len(rows) in (split, len(epochs)):
            with torch.no_grad():
                marks.append({k: v.detach().cpu().clone() for k, v in params.items()})
    p_split, p_end = marks[0], marks[-1]
    return {"rows": rows[:split], "window_rows": rows[split:], "grads": first,
            "changes": {k: p_split[k] - params0[k].cpu() for k in p_split},
            "window_changes": {k: p_end[k] - p_split[k] for k in p_end}}
