"""Model zoo: the U-Net, TransUNet and Swin-Unet, by name through :func:`build_model`."""

from torch import nn

from .swin_unet import SwinUnet
from .transunet import TransUNet
from .unet import ACTIVATIONS, DoubleConv, UNet, count_parameters, mish  # noqa: F401

__all__ = ["UNet", "TransUNet", "SwinUnet", "DoubleConv", "count_parameters", "mish", "ACTIVATIONS",
           "MODELS", "DATA_SIDES", "build_model", "data_side", "require_unet"]

MODELS = {"unet": UNet, "transunet": TransUNet, "swinunet": SwinUnet}
# The side that images read from disk are resized to for each model: the
# reference's 128, or the least side a Swin-Unet at its default widths takes.
DATA_SIDES = {"unet": 128, "transunet": 128, "swinunet": SwinUnet.side_unit()}


def _require_known(name: str) -> None:
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; expected one of {sorted(MODELS)}")


def build_model(name: str, *, image_size: int, base_channels: int = 64,
                param_init: str = "lecun", generator=None, **kw) -> nn.Module:
    """The model ``name`` of :data:`MODELS` for a run's settings: the U-Net
    takes ``base_channels`` and ``param_init``, the TransUNet and the
    Swin-Unet (at their published widths) are built for square images of
    side ``image_size``, a multiple of 16 and of 224 respectively.
    ``generator`` draws the initial weights; ``kw`` goes to the constructor."""
    _require_known(name)
    settings = {"unet": dict(base_channels=base_channels, param_init=param_init),
                "transunet": dict(img_size=image_size),
                "swinunet": dict(img_size=image_size)}[name]
    return MODELS[name](generator=generator, **settings, **kw)


def data_side(name: str) -> int:
    """The side of :data:`DATA_SIDES` that images from disk take for model ``name``."""
    _require_known(name)
    return DATA_SIDES[name]


def require_unet(model: nn.Module, path: str) -> None:
    """Raise ``ValueError`` unless ``model`` is a :class:`UNet`: ``path``
    (named in the message) is written for the U-Net's structure."""
    if not isinstance(model, UNet):
        raise ValueError(f"{path} runs the U-Net only; got {type(model).__name__}")
