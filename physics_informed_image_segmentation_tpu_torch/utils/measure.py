"""What the measurement entry points share: the Stage II objective they
train, the kernels' launch counts, the facts of the device a line was
measured on, and building the kernels before anything is timed.

Used by ``bench`` and the ``scripts`` package; nothing here times or runs
a workload.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..ops import padded_physics_kernel as K3
from ..ops import physics_kernel as K1
from ..train import adamw_kernel as K2
from .device import card_line

__all__ = ["STAGE2", "PEAK_FLOPS", "PEAK_INT8_OPS", "PEAK_SOURCE", "launch_counts",
           "device_facts", "build_kernels"]

# the ``LossConfig`` values of the workloads they train: the Stage II objective
STAGE2 = dict(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0,
              reaction_threshold=0.5, epsilon=0.05)

# bf16 and int8 dense tensor-core peaks by ``torch.cuda.get_device_name``
PEAK_SOURCE = "NVIDIA H100 data sheet, dense (without sparsity), at the part's full power limit"
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # SXM
    "NVIDIA H100 PCIe": 756e12,
}
PEAK_INT8_OPS = {
    "NVIDIA H100 80GB HBM3": 1978.9e12,
    "NVIDIA H100 PCIe": 1513e12,
}


def launch_counts() -> dict:
    """The launch counts of K1, K2 and K3 (a copy)."""
    return {**K1.launch_counts, **K2.launch_counts, **K3.launch_counts}


def device_facts(device: torch.device) -> dict:
    """``device_kind``, ``peak_flops_assumed`` and ``card`` of ``device``."""
    if device.type != "cuda":
        return {"device_kind": "cpu", "peak_flops_assumed": None,
                "card": "cpu (host clock, plain versions: not a device time)"}
    kind = torch.cuda.get_device_name(device)
    return {"device_kind": kind, "peak_flops_assumed": PEAK_FLOPS.get(kind), "card": card_line()}


def build_kernels(device: torch.device) -> Optional[float]:
    """Build K1, K2 and K3 before anything is timed; seconds it took."""
    if device.type != "cuda":
        return None
    from .cuda_build import build_all

    t0 = time.perf_counter()
    build_all(["physics_sums", "padded_physics", "adamw"])
    return time.perf_counter() - t0
