"""Process groups for data- and space-parallel training.

Counterpart of ``physics_informed_image_segmentation_tpu/parallel/mesh.py``.
The JAX package lays its devices out as a ``(data, space)`` mesh and lets
XLA's partitioner place collectives; here every rank is one process with
one device, and the mesh is a :class:`torch.distributed.device_mesh.DeviceMesh`
with the same two axes:

* ``data``  — batch (data-parallel) axis, outermost;
* ``space`` — image-height (spatial-parallel) axis: the convolutions and
  the PDE stencils shard over H with one-row halos (:mod:`.halo`).

The GPU uses NCCL and the CPU gloo; nothing falls back from one to the
other.  The dataset stays replicated on every rank, and each rank cuts its
own share out of every global batch (:func:`batch_sharding`,
:func:`batch_space_sharding`), as the JAX package's devices do.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "initialize_distributed",
    "batch_sharding",
    "batch_space_sharding",
    "all_sum",
    "all_reduce_grads",
    "DATA_AXIS",
    "SPACE_AXIS",
]

DATA_AXIS = "data"
SPACE_AXIS = "space"


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    *,
    device=None,
    timeout: float = 600.0,
) -> None:
    """Join the process group; a second call does nothing.

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); with
    none of those set either, the process is a world of one (an in-memory
    store, no port, no file).  ``init_method`` is a ``tcp://`` or
    ``file://`` URL, given with ``world_size`` and ``rank``, which default
    to ``WORLD_SIZE`` and ``RANK`` of the environment (:mod:`.launch` sets
    them and passes a ``file://`` store).

    ``backend`` defaults to NCCL when ``device`` is CUDA (the default) and
    gloo when it is the CPU.  On CUDA the rank's device is set to
    ``LOCAL_RANK`` (0 without torchrun) before the group is made.
    ``timeout``: seconds a collective may wait before it raises.
    """
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout))
    if init_method is None and world_size is None and "RANK" not in os.environ:
        dist.init_process_group(store=dist.HashStore(), world_size=1, rank=0, **kw)
        return
    if init_method is not None:
        kw["init_method"] = init_method
        if world_size is None and "WORLD_SIZE" in os.environ:
            world_size = int(os.environ["WORLD_SIZE"])
        if rank is None and "RANK" in os.environ:
            rank = int(os.environ["RANK"])
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(**kw)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(data, space)`` mesh.

    ``data``/``space`` are the axis sizes, ``data_rank``/``space_rank``
    this rank's coordinates, ``data_group``/``space_group`` the process
    groups along each axis, and ``device`` the rank's device.  The mesh
    spans the whole world, so a reduction over both axes uses the default
    group.
    """

    device_mesh: object
    data: int
    space: int
    data_rank: int
    space_rank: int
    data_group: object
    space_group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SPACE_AXIS: self.space}

    def global_rank(self, data_rank: int, space_rank: int) -> int:
        return int(self.device_mesh.mesh[data_rank, space_rank])

    def space_neighbours(self) -> tuple[Optional[int], Optional[int]]:
        """Global ranks of the band above and below this one (None at the
        global top and bottom edges)."""
        prev = (self.global_rank(self.data_rank, self.space_rank - 1)
                if self.space_rank > 0 else None)
        nxt = (self.global_rank(self.data_rank, self.space_rank + 1)
               if self.space_rank < self.space - 1 else None)
        return prev, nxt

    def group(self, axes) -> Optional[object]:
        """The process group over ``axes`` (a name or a tuple of names);
        ``None`` — the default group — for both axes."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if set(axes) == {DATA_AXIS, SPACE_AXIS}:
            return None
        if axes == (DATA_AXIS,):
            return self.data_group
        if axes == (SPACE_AXIS,):
            return self.space_group
        raise ValueError(f"unknown mesh axes {axes}")


def make_mesh(data: Optional[int] = None, space: int = 1) -> Mesh:
    """Mesh with ``(data, space)`` axes over every rank, ``data`` outermost.

    ``data=None`` takes all ranks left after ``space``.  Call
    :func:`initialize_distributed` first.  A rank's device is the CUDA
    device it was given, or the CPU under gloo.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("call initialize_distributed() before make_mesh()")
    n = dist.get_world_size()
    if data is None:
        if n % space != 0:
            raise ValueError(f"{n} ranks not divisible by space={space}")
        data = n // space
    if data * space != n:
        raise ValueError(f"mesh {data}x{space} needs {data * space} ranks, the world has {n}")
    if dist.get_backend() == "nccl":
        device_type, device = "cuda", torch.device("cuda", torch.cuda.current_device())
    else:
        device_type, device = "cpu", torch.device("cpu")
    dm = init_device_mesh(device_type, (data, space), mesh_dim_names=(DATA_AXIS, SPACE_AXIS))
    return Mesh(
        device_mesh=dm, data=data, space=space,
        data_rank=dm.get_local_rank(DATA_AXIS), space_rank=dm.get_local_rank(SPACE_AXIS),
        data_group=dm.get_group(DATA_AXIS), space_group=dm.get_group(SPACE_AXIS),
        device=device,
    )


class _AllSum(torch.autograd.Function):
    """Sum over a process group forward, identity backward: every rank's
    loss is the global one, and each rank's gradient is that of its own
    terms (the gradient all-reduce adds them)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_sum(x: torch.Tensor, mesh: Mesh, axes=(DATA_AXIS, SPACE_AXIS)) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``axes``."""
    return _AllSum.apply(x, mesh.group(axes))


@torch.no_grad()
def all_reduce_grads(grads) -> list:
    """Sum a list of gradients over every rank, in one collective."""
    grads = list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
    return out


def _rows(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts != 0:
        raise ValueError(f"{what} {n} is not divisible by {parts} ranks")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def batch_sharding(mesh: Mesh):
    """``cut(x)``: this rank's samples of a replicated global batch
    (``x`` (B, ...), B divisible by ``mesh.data``)."""

    def cut(x: torch.Tensor) -> torch.Tensor:
        return x[_rows(x.shape[0], mesh.data, mesh.data_rank, "batch")]

    return cut


def batch_space_sharding(mesh: Mesh):
    """``cut(x)``: this rank's samples and band of image rows of a
    replicated (B, H, W[, C]) global batch (H divisible by ``mesh.space``)."""
    by_batch = batch_sharding(mesh)

    def cut(x: torch.Tensor) -> torch.Tensor:
        x = by_batch(x)
        return x[:, _rows(x.shape[1], mesh.space, mesh.space_rank, "image height")]

    return cut
