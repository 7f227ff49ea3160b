"""Fused AdamW: the hand-written CUDA kernel, its wrapper and its optimizer.

Counterpart of ``physics_informed_image_segmentation_tpu/train/pallas_optim.py``
(``pallas_adamw``).  One kernel launch updates every parameter tensor in
place (``csrc/adamw.cu`` explains its chunk table); the arithmetic is
:class:`.optim.AdamW`'s, one rounding per operation, so the two are
bit-equal.

Dispatch is by the device of the tensors, with no fallback:

* CUDA tensors go to the kernel, which is built on first use; a kernel
  that fails to build or launch raises;
* CPU tensors go to :func:`.optim.adamw_foreach_`, the plain version.

``launch_counts["adamw"]`` counts the kernel's launches (one per step
for up to 64 tensors), so a run can show that it went through the
kernel; :func:`reset_launch_counts` sets it to 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .optim import AdamW, adamw_foreach_

__all__ = ["FusedAdamW", "fused_adamw_", "launch_counts", "reset_launch_counts"]

launch_counts = {"adamw": 0}

_MAX_ELEMS = 2**31 - 1


def reset_launch_counts() -> None:
    launch_counts["adamw"] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import load_library

    lib = load_library("adamw")
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.adamw_step.argtypes = [p, p, p, p, p, i, f, f, f, f, p, ctypes.POINTER(i)]
    lib.adamw_step.restype = i
    return lib


def _check(params, grads, m, v) -> torch.device:
    if not (len(params) == len(grads) == len(m) == len(v)):
        raise ValueError(f"params, grads, m, v must have equal lengths; got "
                         f"{len(params)}, {len(grads)}, {len(m)}, {len(v)}")
    device = params[0].device
    for k, quad in enumerate(zip(params, grads, m, v)):
        n = quad[0].numel()
        for name, x in zip("pgmv", quad):
            if x.dtype != torch.float32:
                raise TypeError(f"{name}[{k}] must be float32; got {x.dtype}")
            if x.device != device:
                raise ValueError(f"{name}[{k}] is on {x.device}, params on {device}")
            if not x.is_contiguous():
                raise ValueError(f"{name}[{k}] must be contiguous")
            if x.numel() != n:
                raise ValueError(f"{name}[{k}] has {x.numel()} elements, p[{k}] {n}")
        if n > _MAX_ELEMS:
            raise ValueError(f"tensor {k} has {n} elements; the kernel takes < 2^31")
    return device


def _launch(params, grads, m, v, bc1, bc2, lr, wd, device) -> None:
    n = len(params)
    ptrs = lambda xs: (ctypes.c_void_p * n)(*(x.data_ptr() for x in xs))
    sizes = (ctypes.c_longlong * n)(*(x.numel() for x in params))
    launches = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _library().adamw_step(
            ptrs(params), ptrs(grads), ptrs(m), ptrs(v), sizes, n,
            bc1, bc2, lr, wd, torch.cuda.current_stream(device).cuda_stream,
            ctypes.byref(launches),
        )
    if err != 0:
        raise RuntimeError(f"adamw launch failed: CUDA error {err}")
    launch_counts["adamw"] += launches.value


@torch.no_grad()
def fused_adamw_(params, grads, m, v, bc1: float, bc2: float, lr: float, wd: float) -> None:
    """One AdamW step over lists of float32 tensors, in place.

    ``bc1``/``bc2`` are the float32 bias corrections
    (:func:`.optim.bias_corrections`).  CUDA tensors launch the kernel;
    CPU tensors take the plain version.
    """
    params, grads, m, v = list(params), list(grads), list(m), list(v)
    device = _check(params, grads, m, v)
    if device.type == "cuda":
        _launch(params, grads, m, v, bc1, bc2, lr, wd, device)
    elif device.type == "cpu":
        adamw_foreach_(params, grads, m, v, bc1, bc2, lr, wd)
    else:
        raise ValueError(f"fused_adamw_ takes CUDA or CPU tensors; got {device}")


class FusedAdamW(AdamW):
    """:class:`.optim.AdamW` whose update is one fused kernel launch on
    the GPU (the port's ``"pallas_adamw"``).

    Gradients in another memory layout than their parameters (the CPU's
    convolutions return channels-last weight gradients) are copied to
    the parameters' layout first.
    """

    def _update(self, grads, bc1, bc2) -> None:
        fused_adamw_(self.params, [g.contiguous() for g in grads], self.m, self.v, bc1, bc2,
                     self.learning_rate, self.weight_decay)
