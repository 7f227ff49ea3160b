"""Model zoo: the U-Net and TransUNet, by name through :func:`build_model`."""

from torch import nn

from .transunet import TransUNet
from .unet import ACTIVATIONS, DoubleConv, UNet, count_parameters, mish  # noqa: F401

__all__ = ["UNet", "TransUNet", "DoubleConv", "count_parameters", "mish", "ACTIVATIONS",
           "MODELS", "build_model", "require_unet"]

MODELS = {"unet": UNet, "transunet": TransUNet}


def build_model(name: str, *, image_size: int, base_channels: int = 64,
                param_init: str = "lecun", generator=None, **kw) -> nn.Module:
    """The model ``name`` of :data:`MODELS` for a run's settings: the U-Net
    takes ``base_channels`` and ``param_init``, the TransUNet (at its
    published widths) is built for square images of side ``image_size``.
    ``generator`` draws the initial weights; ``kw`` goes to the constructor."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(MODELS)}")
    settings = {"unet": dict(base_channels=base_channels, param_init=param_init),
                "transunet": dict(img_size=image_size)}[name]
    return MODELS[name](generator=generator, **settings, **kw)


def require_unet(model: nn.Module, path: str) -> None:
    """Raise ``ValueError`` unless ``model`` is a :class:`UNet`: ``path``
    (named in the message) is written for the U-Net's structure."""
    if not isinstance(model, UNet):
        raise ValueError(f"{path} runs the U-Net only; got {type(model).__name__}")
