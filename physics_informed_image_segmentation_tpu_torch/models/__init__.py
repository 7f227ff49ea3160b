"""Model zoo."""

from .unet import ACTIVATIONS, DoubleConv, UNet, count_parameters  # noqa: F401

__all__ = ["UNet", "DoubleConv", "count_parameters", "ACTIVATIONS"]
