"""Differentiable ops: PDE stencils, losses, metrics, the fused CUDA kernel."""

from . import losses, metrics, pde, physics_kernel, stats  # noqa: F401

__all__ = ["pde", "losses", "metrics", "physics_kernel", "stats"]
