"""The comparison that decides ``correct``: the numbers compared and their limits.

Training cells compare the program's first steps with the reference's
(:func:`train_numbers`); serving cells compare the masks the program
returned with the reference's logits (:func:`mask_gap`).  Every number is
a gap: 0 when the two agree, and the run is correct when each number is
finite and at most its limit.
"""

from __future__ import annotations

import math
import statistics

import torch

__all__ = ["train_numbers", "leaf_gaps", "mask_gap", "verdict", "METRIC_KEYS", "LEAF_RULE"]

PHYSICS_KEYS = ("train_pde_loss", "train_phase_field_loss", "val_pde_loss",
                "val_phase_field_loss")
METRIC_KEYS = ("train_dice_score", "train_iou_score", "train_boundary_f1_score",
               "val_dice_score", "val_iou_score", "val_boundary_f1_score")
# a leaf whose reference gradient is under this share of the median leaf's
# moves under AdamW by round-off alone: it is left out of the leaf gaps
LEAF_RULE = 1e-3


def _norms(leaves: dict) -> dict:
    return {k: float(v.norm()) for k, v in leaves.items()}


def leaf_gaps(prog: dict, ref: dict, ref_grads: dict, diff: bool = False) -> dict:
    """Each counted leaf's gap against ``max(its reference norm, the median
    leaf's)``: of the norms, ``|norm_prog - norm_ref|``, or with ``diff`` the
    norm of the difference.  A leaf whose reference gradient's norm is under
    ``LEAF_RULE`` of the median leaf's is not counted."""
    gnorm, rnorm = _norms(ref_grads), _norms(ref)
    floor = LEAF_RULE * statistics.median(gnorm.values())
    keys = [k for k in ref if gnorm[k] >= floor]
    med = statistics.median(rnorm[k] for k in keys)
    if diff:
        return {k: float((prog[k] - ref[k]).norm()) / max(rnorm[k], med) for k in keys}
    pnorm = _norms(prog)
    return {k: abs(pnorm[k] - rnorm[k]) / max(rnorm[k], med) for k in keys}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``rows`` (one a set-up epoch of one step),
    ``window_rows`` (the window's first epoch), ``grads`` (the first step's
    gradient), ``changes`` (the parameters' change over the set-up's steps)
    and ``window_changes`` (over the window's first epoch), by leaf name.

    * ``loss_gap``: the largest relative gap of an epoch's training loss or
      of its validation pass's loss, over every epoch;
    * ``physics_gap``: the same of the set-up epochs' two physics terms
      (K1's sums), unweighted;
    * ``grad_gap`` / ``change_gap`` / ``window_change_gap``: the worst
      leaf's gap of the first gradient's norm / of the set-up's change's
      norm / of the window epoch's change's norm;
    * ``metric_gap``: the largest absolute gap of a set-up epoch's Dice,
      IoU or Boundary-F1, of its training step or of its validation pass.
    """
    names = ("loss_gap", "physics_gap", "grad_gap", "change_gap", "window_change_gap",
             "metric_gap")
    if any(len(prog[k]) != len(ref[k]) for k in ("rows", "window_rows")):
        return {k: math.inf for k in names}
    setup = list(zip(prog["rows"], ref["rows"]))
    every = setup + list(zip(prog["window_rows"], ref["window_rows"]))

    def rel(pairs, keys):
        return max(abs(p[k] - r[k]) / abs(r[k]) for p, r in pairs for k in keys)

    def worst(key):
        return max(leaf_gaps(prog[key], ref[key], ref["grads"]).values())

    return {"loss_gap": rel(every, ("train_loss", "val_loss")),
            "physics_gap": rel(setup, PHYSICS_KEYS),
            "grad_gap": worst("grads"), "change_gap": worst("changes"),
            "window_change_gap": worst("window_changes"),
            "metric_gap": max(abs(p[k] - r[k]) for p, r in setup for k in METRIC_KEYS)}


def mask_gap(masks: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """The widest reference logit at a pixel where the program's mask (0/1,
    thresholded at probability 0.5) says the other side: 0 when every
    pixel agrees; inf when the masks are not 0/1 masks of the right shape."""
    if masks.shape != ref_logits.shape or not bool(((masks == 0) | (masks == 1)).all()):
        return math.inf
    wrong = (masks > 0.5) != (ref_logits > 0)
    if not bool(wrong.any()):
        return 0.0
    return float(ref_logits.abs()[wrong].max())


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    is finite and at most its limit, and every limit has its number."""
    table = {name: {"value": numbers.get(name, math.nan), "limit": lim}
             for name, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
