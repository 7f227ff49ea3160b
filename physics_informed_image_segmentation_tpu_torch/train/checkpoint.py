"""Final-artifact checkpoints: the U-Net ``state_dict`` as a ``.pth`` file.

The keys are the reference keys, so a saved file loads into the port's
:class:`..models.UNet` and into the reference PyTorch model alike.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

__all__ = ["save_params", "load_params"]


def save_params(model: torch.nn.Module, path) -> Path:
    """Save ``model.state_dict()`` (moved to the CPU) to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def load_params(path, model: Optional[torch.nn.Module] = None):
    """Load a ``.pth`` state dict; with ``model``, load it into the model
    (strictly) and return the model."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        return state_dict
    model.load_state_dict(state_dict)
    return model
