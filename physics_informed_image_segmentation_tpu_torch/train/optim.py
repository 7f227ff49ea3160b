"""AdamW in optax's order of operations, and its storage variants.

Counterpart of the JAX package's optimizers: ``optax.adamw`` (the
default; its formulas are spelled out in ``train/pallas_optim.py``) and
``train/optim.py``'s ``flat_adamw``, ``grouped_adamw`` and
``low_precision_adamw``.  Every update is written as plain tensor code
over all tensors at once (``torch._foreach_*``), one rounding per
operation:

    m ← (1-b1)·g + b1·m
    v ← (1-b2)·g² + b2·v
    u ← (m / bc1) / (√(v / bc2) + eps),   bc_i = 1 - b_i^count
    p ← p + (-lr)·(u + wd·p)

``torch.optim.AdamW`` applies the decay before the moment update and
folds the bias corrections into the step size, which rounds differently
and would not follow the JAX package step for step.  Parameters and
moments are updated in place.

* :class:`AdamW` keeps one m and one v per parameter.
* :class:`GroupedAdamW` keeps the moments of every parameter of at most
  ``max_group_elems`` elements in one flat buffer each; bigger
  parameters keep their own.  :class:`FlatAdamW` groups them all.  Both
  are storage layouts only: their updates are bit-identical to
  :class:`AdamW`'s.
* :class:`LowPrecisionAdamW` stores m (and optionally v) in bfloat16 and
  computes in float32.  It is an approximation, not a layout.

Every optimizer has ``step(grads)``, ``count``, ``state_dict()`` and
``load_state_dict()``; the last copies into the existing tensors, so
the moments keep their storage.
"""

from __future__ import annotations

import sys
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "AdamW",
    "FlatAdamW",
    "GroupedAdamW",
    "LowPrecisionAdamW",
    "bias_corrections",
    "adamw_foreach_",
]

# optax.adamw's defaults, the only values the JAX package trains with
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def bias_corrections(count: int) -> tuple[float, float]:
    """``(1 - b1^count, 1 - b2^count)`` in float32, as optax computes them."""
    c = np.float32(count)
    return (float(np.float32(1.0) - np.float32(_B1) ** c),
            float(np.float32(1.0) - np.float32(_B2) ** c))


def _update_moments_(m, v, grads) -> None:
    torch._foreach_mul_(m, _B1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - _B1))
    torch._foreach_mul_(v, _B2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - _B2))


def _true_div(tensors, divisor: float) -> list:
    """``tensors / divisor`` as true division, rounded once, as optax's
    ``m / bc1`` is.  On the GPU PyTorch divides by a Python float as a
    multiplication by its reciprocal, which misses by an ulp in about half
    of the elements; a 0-dim tensor on the tensors' device is divided by
    truly (and ``torch.full`` fills it without a host-device copy)."""
    d = torch.full((), divisor, dtype=torch.float32, device=tensors[0].device)
    return torch._foreach_div(tensors, d)


def _direction(m, v, bc1: float, bc2: float) -> list:
    """``(m / bc1) / (√(v / bc2) + eps)``, one new tensor per moment."""
    denom = _true_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, _EPS)
    upd = _true_div(m, bc1)
    torch._foreach_div_(upd, denom)
    return upd


def _apply_(params, upd, lr: float, wd: float) -> None:
    """``p ← p + (-lr)·(u + wd·p)``; overwrites ``upd``."""
    torch._foreach_add_(upd, torch._foreach_mul(params, wd))
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)


@torch.no_grad()
def adamw_foreach_(params, grads, m, v, bc1: float, bc2: float, lr: float, wd: float) -> None:
    """One AdamW step over lists of float32 tensors, in place.

    The plain version of the fused AdamW kernel (:mod:`.adamw_kernel`)
    and the update of :class:`AdamW`.
    """
    _update_moments_(m, v, grads)
    _apply_(params, _direction(m, v, bc1, bc2), lr, wd)


class AdamW:
    """AdamW over a fixed list of float32 parameters."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        learning_rate: float,
        weight_decay: float = 1e-5,
    ):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.count = 0
        self.m, self.v = self._init_moments()

    def _init_moments(self) -> tuple[list, list]:
        return ([torch.zeros_like(p) for p in self.params],
                [torch.zeros_like(p) for p in self.params])

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update from ``grads`` (same order as ``params``)."""
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"expected {len(self.params)} gradients, got {len(grads)}")
        self.count += 1
        self._update(grads, *bias_corrections(self.count))

    def _update(self, grads, bc1: float, bc2: float) -> None:
        adamw_foreach_(self.params, grads, self.m, self.v, bc1, bc2,
                       self.learning_rate, self.weight_decay)

    def state_dict(self) -> dict:
        """The step count and the moments (the tensors themselves, not copies)."""
        return {"kind": type(self).__name__, "count": self.count, "m": list(self.m),
                "v": list(self.v)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into this optimizer's own tensors."""
        if state.get("kind") != type(self).__name__:
            raise ValueError(f"state of a {state.get('kind')} cannot load into a "
                             f"{type(self).__name__}")
        for key in ("m", "v"):
            ours, theirs = getattr(self, key), state[key]
            if len(ours) != len(theirs) or any(
                a.shape != b.shape or a.dtype != b.dtype for a, b in zip(ours, theirs)
            ):
                raise ValueError(f"optimizer state {key!r} does not match this optimizer's")
            torch._foreach_copy_(ours, list(theirs))
        self.count = int(state["count"])


class GroupedAdamW(AdamW):
    """AdamW whose small parameters share flat moment buffers.

    Parameters of at most ``max_group_elems`` elements have their m and v
    in one flat float32 buffer each (``m[0]``, ``v[0]``); the others keep
    their own (``m[1:]``, ``v[1:]``).  The gradients of the small ones are
    concatenated each step.  Bit-identical to :class:`AdamW`.
    """

    def __init__(self, params, learning_rate, weight_decay=1e-5,
                 max_group_elems: int = 1_400_000):
        self.max_group_elems = max_group_elems
        super().__init__(params, learning_rate, weight_decay)

    def _init_moments(self) -> tuple[list, list]:
        self.small = [i for i, p in enumerate(self.params) if p.numel() <= self.max_group_elems]
        small = set(self.small)
        self.big = [i for i in range(len(self.params)) if i not in small]
        n_small = sum(self.params[i].numel() for i in self.small)
        flat = torch.zeros(n_small, dtype=torch.float32, device=self.params[0].device)
        big = [torch.zeros_like(self.params[i]) for i in self.big]
        return [flat, *big], [torch.zeros_like(flat), *(torch.zeros_like(b) for b in big)]

    def _update(self, grads, bc1, bc2) -> None:
        g_flat = (torch.cat([grads[i].reshape(-1) for i in self.small]) if self.small
                  else self.m[0].new_zeros(0))
        _update_moments_(self.m, self.v, [g_flat, *(grads[i] for i in self.big)])
        upd_flat, *upd_big = _direction(self.m, self.v, bc1, bc2)
        upd = [None] * len(self.params)
        off = 0
        for i in self.small:
            n = self.params[i].numel()
            upd[i] = upd_flat[off:off + n].view(self.params[i].shape)
            off += n
        for i, u in zip(self.big, upd_big):
            upd[i] = u
        _apply_(self.params, upd, self.learning_rate, self.weight_decay)


class FlatAdamW(GroupedAdamW):
    """AdamW with m and v each one flat float32 buffer over every
    parameter.  Bit-identical to :class:`AdamW`."""

    def __init__(self, params, learning_rate, weight_decay=1e-5):
        super().__init__(params, learning_rate, weight_decay, max_group_elems=sys.maxsize)


class LowPrecisionAdamW(AdamW):
    """AdamW with reduced-precision moment storage and float32 compute.

    ``m_dtype`` / ``v_dtype`` are the storage types (bfloat16 m and
    float32 v by default).  Each step widens the moments to float32,
    updates them with :class:`AdamW`'s formulas and rounds them back
    (``.to(torch.bfloat16)``, round to nearest even).  Not bit-identical
    to :class:`AdamW`: the stored moments are quantised.  A bfloat16 v is
    accepted but doubtful: with b2 = 0.999 both its decay and its
    increment lie below one bfloat16 ulp.
    """

    def __init__(self, params, learning_rate, weight_decay=1e-5,
                 m_dtype: torch.dtype = torch.bfloat16, v_dtype: torch.dtype = torch.float32):
        self.m_dtype, self.v_dtype = m_dtype, v_dtype
        super().__init__(params, learning_rate, weight_decay)

    def _init_moments(self) -> tuple[list, list]:
        return ([torch.zeros_like(p, dtype=self.m_dtype) for p in self.params],
                [torch.zeros_like(p, dtype=self.v_dtype) for p in self.params])

    def _update(self, grads, bc1, bc2) -> None:
        m32 = [x.to(torch.float32) for x in self.m]
        v32 = [x.to(torch.float32) for x in self.v]
        adamw_foreach_(self.params, grads, m32, v32, bc1, bc2,
                       self.learning_rate, self.weight_decay)
        for stored, computed in ((self.m, m32), (self.v, v32)):
            if stored[0].dtype != torch.float32:  # float32 moments were updated in place
                torch._foreach_copy_(stored, computed)
