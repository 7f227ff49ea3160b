"""PyTorch/CUDA port of physics_informed_image_segmentation_tpu.

Two-stage PDE-regularised U-Net training for cell segmentation on an
NVIDIA GPU: the same model, objective, metrics and pipeline as the JAX
package, with the fused physics-loss kernel written by hand in CUDA
(``csrc/physics_sums.cu``).  Entry points run on CUDA unless they are
given ``device="cpu"``.
"""

from .models import UNet, count_parameters  # noqa: F401
from .train import LossConfig, make_loss_and_components, train  # noqa: F401

__version__ = "0.1.0"

__all__ = ["UNet", "count_parameters", "LossConfig", "make_loss_and_components", "train"]
