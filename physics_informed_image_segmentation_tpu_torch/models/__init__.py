"""Model zoo: the U-Net and TransUNet, by name through :func:`build_model`."""

from torch import nn

from .transunet import TransUNet
from .unet import ACTIVATIONS, DoubleConv, UNet, count_parameters, mish  # noqa: F401

__all__ = ["UNet", "TransUNet", "DoubleConv", "count_parameters", "mish", "ACTIVATIONS",
           "build_model", "require_unet"]

MODELS = {"unet": UNet, "transunet": TransUNet}


def build_model(name: str, **kw) -> nn.Module:
    """The model ``name`` (``"unet"`` or ``"transunet"``) built with ``kw``."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(MODELS)}")
    return MODELS[name](**kw)


def require_unet(model: nn.Module, path: str) -> None:
    """Raise ``ValueError`` unless ``model`` is a :class:`UNet`: ``path``
    (named in the message) is written for the U-Net's structure."""
    if not isinstance(model, UNet):
        raise ValueError(f"{path} runs the U-Net only; got {type(model).__name__}")
