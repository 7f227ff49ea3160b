"""AdamW as optax applies it (the reference's optimizer in the JAX package's
order of operations), on a dict of float32 tensors:

    m <- 0.9 m + 0.1 g
    v <- 0.999 v + 0.001 g^2
    p <- p - lr ((m / (1 - 0.9^t)) / (sqrt(v / (1 - 0.999^t)) + 1e-8) + wd p)
"""

from __future__ import annotations

import torch

__all__ = ["AdamW"]


class AdamW:
    def __init__(self, params: dict, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            u = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps)
            p -= self.lr * (u + self.wd * p)
