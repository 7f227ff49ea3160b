"""AdamW in optax's order of operations.

Counterpart of the JAX package's default optimizer, ``optax.adamw`` (its
formulas are spelled out in ``train/pallas_optim.py``), written as plain
tensor code over all parameters at once (``torch._foreach_*``):

    m ← (1-b1)·g + b1·m
    v ← (1-b2)·g² + b2·v
    u ← (m / bc1) / (√(v / bc2) + eps),   bc_i = 1 - b_i^count
    p ← p + (-lr)·(u + wd·p)

``torch.optim.AdamW`` applies the decay before the moment update and
folds the bias corrections into the step size, which rounds differently
and would not follow the JAX package step for step.  Parameters and
moments are updated in place.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["AdamW"]

# optax.adamw's defaults, the only values the JAX package trains with
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


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
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply one update from ``grads`` (same order as ``params``)."""
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"expected {len(self.params)} gradients, got {len(grads)}")
        self.count += 1
        b1, b2 = _B1, _B2
        # bias corrections in float32, as optax computes them
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))

        torch._foreach_mul_(self.m, b1)
        torch._foreach_add_(self.m, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.v, b2)
        torch._foreach_add_(self.v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))

        denom = torch._foreach_div(self.v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        upd = torch._foreach_div(self.m, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -self.learning_rate)
        torch._foreach_add_(self.params, upd)
