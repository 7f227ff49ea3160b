"""Device selection for the port's entry points.

Every entry point runs on the GPU unless its caller asks for the CPU
(``device="cpu"``).  There is no silent fallback: asking for CUDA on a
machine without a usable card raises.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "set_precision", "autocast"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must be available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


def set_precision(precision: str) -> str:
    """Validate ``precision`` ("bf16" | "f32") and set the matching flags.

    ``"f32"`` turns TF32 off for cuDNN convolutions and CUDA matmuls
    (``torch.backends.cudnn.allow_tf32 = False`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False``), process-wide, so
    float32 really computes in float32.  ``"bf16"`` leaves the flags
    alone: the U-Net then runs under ``torch.autocast(..., torch.bfloat16)``
    (see :func:`autocast`).
    """
    if precision in ("bf16", "bfloat16"):
        return "bf16"
    if precision in ("f32", "float32"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return "f32"
    raise ValueError(f"unknown precision: {precision}")


def autocast(device: torch.device, precision: str):
    """Autocast context for the U-Net forward: bf16 under ``"bf16"``."""
    return torch.autocast(
        device_type=device.type, dtype=torch.bfloat16, enabled=precision == "bf16"
    )
