"""Fused AdamW: the hand-written CUDA kernel, its wrapper and its optimizer.

Counterpart of ``physics_informed_image_segmentation_tpu/train/pallas_optim.py``
(``pallas_adamw``).  One kernel launch updates every parameter tensor in
place (``csrc/adamw.cu``); the arithmetic is :class:`.optim.AdamW`'s, one
rounding per operation, so the two are bit-equal.

The kernel runs near its byte bound, so what a step costs is the host's
work before the launch.  :class:`AdamWPlan` keeps that to what changes:
parameters and moments are validated once, and their pointers, sizes and
the list of chunks are uploaded once to the card; a step checks the
gradients, passes their pointers and the step's scalars, and makes one
ctypes call.  A plan knows the addresses it was built from
(:meth:`AdamWPlan.matches`), and :class:`FusedAdamW` builds a new one when
a parameter or moment tensor was replaced or moved, so a stale plan never
updates freed memory.

Dispatch is by the device of the tensors, with no fallback:

* CUDA tensors go to the kernel, which is built on first use; a kernel
  that fails to build or launch raises;
* CPU tensors go to :func:`.optim.adamw_foreach_`, the plain version.

``launch_counts["adamw"]`` counts the kernel's launches (one per step
for up to 64 tensors), so a run can show that it went through the
kernel; :func:`reset_launch_counts` sets it to 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import struct

import numpy as np
import torch

from .optim import AdamW, adamw_foreach_

__all__ = ["AdamWPlan", "FusedAdamW", "fused_adamw_", "plan_groups", "launch_counts",
           "reset_launch_counts"]

launch_counts = {"adamw": 0}

_MAX_ELEMS = 2**31 - 1
# csrc/adamw.cu's kChunk and kMaxTensors; _library() checks them
_CHUNK = 4096
_MAX_TENSORS = 64


def reset_launch_counts() -> None:
    launch_counts["adamw"] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("adamw")
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.adamw_plan_layout.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.adamw_plan_layout.restype = None
    lib.adamw_step.argtypes = [p, p, i, i, p, f, f, f, f, p]
    lib.adamw_step.restype = i
    chunk, max_tensors = i(0), i(0)
    lib.adamw_plan_layout(ctypes.byref(chunk), ctypes.byref(max_tensors))
    if (chunk.value, max_tensors.value) != (_CHUNK, _MAX_TENSORS):
        raise RuntimeError(f"csrc/adamw.cu plans by ({chunk.value}, {max_tensors.value}), "
                           f"the wrapper by ({_CHUNK}, {_MAX_TENSORS})")
    return lib


def plan_groups(sizes, chunk: int = _CHUNK, max_tensors: int = _MAX_TENSORS) -> list:
    """The launches of one step over tensors of ``sizes`` elements.

    Zero-size tensors are left out; the others go, in order, into groups
    of at most ``max_tensors``, one launch each.  Returns a list of
    ``(indices, chunk_start)``: the tensors' positions in ``sizes`` and
    the prefix sum of their chunk counts (``ceil(size / chunk)``), so
    ``chunk_start[-1]`` is the launch's grid.
    """
    live = [k for k, n in enumerate(sizes) if n > 0]
    groups = []
    for at in range(0, len(live), max_tensors):
        indices = live[at:at + max_tensors]
        counts = [-(-sizes[k] // chunk) for k in indices]
        groups.append((indices, [0, *itertools.accumulate(counts)]))
    return groups


def _chunk_table(chunk_start) -> np.ndarray:
    """``(n_chunks, 2)`` int32: for every block its tensor (position in the
    group) and its chunk within that tensor."""
    counts = np.diff(np.asarray(chunk_start, np.int64))
    tensor = np.repeat(np.arange(len(counts)), counts)
    within = np.arange(chunk_start[-1]) - np.repeat(np.asarray(chunk_start[:-1]), counts)
    return np.stack([tensor, within], axis=1).astype(np.int32)


def _pointers(*lists) -> tuple:
    return tuple(map(torch.Tensor.data_ptr, itertools.chain(*lists)))


class AdamWPlan:
    """What every step over the same parameters and moments shares.

    Built from ``params``, ``m`` and ``v`` (equal-length lists of
    contiguous float32 tensors on one device, validated here and not
    again).  For CUDA tensors the groups of :func:`plan_groups` are
    uploaded: per group a ``(4, count)`` int64 table (pointers of p, m, v
    and the sizes) and the ``(n_chunks, 2)`` int32 chunk list.
    """

    def __init__(self, params, m, v):
        params, m, v = list(params), list(m), list(v)
        if not (len(params) == len(m) == len(v)):
            raise ValueError(f"params, m, v must have equal lengths; got "
                             f"{len(params)}, {len(m)}, {len(v)}")
        if not params:
            raise ValueError("no parameters to plan for")
        self.device = params[0].device
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"the fused AdamW takes CUDA or CPU tensors; got {self.device}")
        self.sizes = [p.numel() for p in params]
        for k, (n, triple) in enumerate(zip(self.sizes, zip(params, m, v))):
            for name, x in zip("pmv", triple):
                _check_tensor(name, k, x, n, self.device)
            if n > _MAX_ELEMS:
                raise ValueError(f"tensor {k} has {n} elements; the kernel takes < 2^31")
        self.params, self.m, self.v = params, m, v
        self.key = _pointers(params, m, v)
        # what a gradient's get_device() must say
        self._index = self.device.index if self.device.type == "cuda" else -1
        self._launches = []  # per group: tensors' positions, table, chunks, grid, pointer packer
        if self.device.type == "cuda":
            for indices, chunk_start in plan_groups(self.sizes):
                rows = [[xs[k].data_ptr() for k in indices] for xs in (params, m, v)]
                rows.append([self.sizes[k] for k in indices])
                table = torch.tensor(rows, dtype=torch.int64).to(self.device)
                chunks = torch.from_numpy(_chunk_table(chunk_start)).to(self.device)
                self._launches.append((indices, table, chunks, chunk_start[-1],
                                       struct.Struct(f"{len(indices)}Q").pack))

    def matches(self, params, m, v) -> bool:
        """Whether these are still the tensors, at the addresses, that the
        plan was built from."""
        return _pointers(params, m, v) == self.key

    def step(self, grads, bc1: float, bc2: float, lr: float, wd: float,
             copy_layout: bool = False) -> None:
        """One update from ``grads``.  Each gradient must be float32, on the
        plan's device, as large as its parameter and contiguous; with
        ``copy_layout`` one in another memory layout is copied first."""
        if len(grads) != len(self.sizes):
            raise ValueError(f"params, grads, m, v must have equal lengths; got "
                             f"{len(self.sizes)} params and {len(grads)} grads")
        index, sizes, f32 = self._index, self.sizes, torch.float32
        ready = grads
        for k, g in enumerate(grads):
            if g.dtype is not f32 or g.get_device() != index or g.numel() != sizes[k]:
                _check_tensor("g", k, g, sizes[k], self.device)
            if not g.is_contiguous():
                if not copy_layout:
                    raise ValueError(f"g[{k}] must be contiguous")
                if ready is grads:
                    ready = list(grads)
                ready[k] = g.contiguous()
        if index < 0:
            adamw_foreach_(self.params, ready, self.m, self.v, bc1, bc2, lr, wd)
            return
        lib = _library()
        pointers = list(map(torch.Tensor.data_ptr, ready))
        # the runtime launches on the current device, which must own the stream
        with (contextlib.nullcontext() if index == torch.cuda.current_device()
              else torch.cuda.device(index)):
            stream = torch._C._cuda_getCurrentRawStream(index)
            for indices, table, chunks, n_chunks, pack in self._launches:
                err = lib.adamw_step(table.data_ptr(), chunks.data_ptr(), len(indices), n_chunks,
                                     pack(*[pointers[k] for k in indices]), bc1, bc2, lr, wd,
                                     stream)
                if err != 0:
                    raise RuntimeError(f"adamw launch failed: CUDA error {err}")
                launch_counts["adamw"] += 1


def _check_tensor(name: str, k: int, x: torch.Tensor, n: int, device: torch.device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}[{k}] must be float32; got {x.dtype}")
    if x.device != device:  # a CUDA tensor knows its index, "cuda" alone does not
        raise ValueError(f"{name}[{k}] is on {x.device}, params on {device}")
    if x.numel() != n:
        raise ValueError(f"{name}[{k}] has {x.numel()} elements, p[{k}] {n}")
    if name != "g" and not x.is_contiguous():
        raise ValueError(f"{name}[{k}] must be contiguous")


@torch.no_grad()
def fused_adamw_(params, grads, m, v, bc1: float, bc2: float, lr: float, wd: float) -> None:
    """One AdamW step over lists of float32 tensors, in place.

    ``bc1``/``bc2`` are the float32 bias corrections
    (:func:`.optim.bias_corrections`).  CUDA tensors launch the kernel;
    CPU tensors take the plain version.  Builds a plan for this one call:
    an optimizer that steps many times keeps one (:class:`FusedAdamW`).
    """
    params, grads = list(params), list(grads)
    if len(grads) != len(params):
        raise ValueError(f"params, grads, m, v must have equal lengths; got "
                         f"{len(params)} params and {len(grads)} grads")
    AdamWPlan(params, m, v).step(grads, bc1, bc2, lr, wd)


class FusedAdamW(AdamW):
    """:class:`.optim.AdamW` whose update is one fused kernel launch on
    the GPU (the port's ``"pallas_adamw"``).

    Its :class:`AdamWPlan` is made at the first step and kept; it is made
    anew after ``load_state_dict`` and whenever ``params``, ``m`` or ``v``
    hold other tensors, or tensors at other addresses, than it was built
    from.  Gradients in another memory layout than their parameters (the
    CPU's convolutions return channels-last weight gradients) are copied
    to the parameters' layout first.
    """

    _plan = None

    def _update(self, grads, bc1, bc2) -> None:
        plan = self._plan
        if plan is None or not plan.matches(self.params, self.m, self.v):
            plan = self._plan = AdamWPlan(self.params, self.m, self.v)
        plan.step(grads, bc1, bc2, self.learning_rate, self.weight_decay, copy_layout=True)

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self._plan = None
