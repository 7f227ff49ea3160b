"""JAX/Flax U-Net parameters → the port's ``state_dict``.

The port's own copy of the layout mapping that the JAX package's
``utils/torch_interop.py`` applies, plus the PReLU weight:

* Conv kernel ``(kh, kw, in, out)`` → Conv2d weight ``(out, in, kh, kw)``;
* ConvTranspose kernel ``(kh, kw, in, out)`` → ConvTranspose2d weight
  ``(in, out, kh, kw)`` with both spatial axes flipped (torch scatters the
  kernel, ``lax.conv_transpose`` correlates);
* the second conv of a DoubleConv sits at Sequential index 3 when the
  block has a Dropout2d (index 2), else at index 2;
* a block's ``prelu_alpha`` is the shared activation's weight, which the
  ``state_dict`` lists under both of its Sequential indices.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]

# (block name, has a Dropout2d when the model's dropout > 0)
_BLOCKS = [
    ("enc1", False),
    ("enc2", True),
    ("enc3", True),
    ("enc4", True),
    ("bottleneck", True),
    ("dec4", True),
    ("dec3", True),
    ("dec2", True),
    ("dec1", False),
]
_TRANSPOSED = ["up4", "up3", "up2", "up1"]


def _tensor(x) -> torch.Tensor:
    return torch.tensor(np.array(x, dtype=np.float32))


def state_dict_from_jax(params: Mapping, dropout: float = 0.2) -> Dict[str, torch.Tensor]:
    """Flax U-Net params (numpy arrays, with or without the top-level
    ``"params"`` key) → ``state_dict`` for :class:`..models.UNet`.

    ``dropout`` must match the port model's construction: it decides the
    Sequential index of each block's second conv.
    """
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    for name, droppable in _BLOCKS:
        conv2_idx = 3 if droppable and dropout > 0 else 2
        for flax_name, idx in (("conv1", 0), ("conv2", conv2_idx)):
            k = np.asarray(p[name][flax_name]["kernel"])
            sd[f"{name}.conv.{idx}.weight"] = _tensor(k.transpose(3, 2, 0, 1))
            sd[f"{name}.conv.{idx}.bias"] = _tensor(p[name][flax_name]["bias"])
        if "prelu_alpha" in p[name]:
            alpha = _tensor(p[name]["prelu_alpha"]).reshape(1)
            sd[f"{name}.conv.1.weight"] = alpha
            sd[f"{name}.conv.{conv2_idx + 1}.weight"] = alpha
    for name in _TRANSPOSED:
        k = np.asarray(p[name]["kernel"])  # (kh, kw, in, out)
        sd[f"{name}.weight"] = _tensor(k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
        sd[f"{name}.bias"] = _tensor(p[name]["bias"])
    sd["out_conv.weight"] = _tensor(np.asarray(p["out_conv"]["kernel"]).transpose(3, 2, 0, 1))
    sd["out_conv.bias"] = _tensor(p["out_conv"]["bias"])
    return sd
