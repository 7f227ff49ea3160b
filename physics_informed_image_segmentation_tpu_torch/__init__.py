"""PyTorch/CUDA port of the JAX package ``physics_informed_image_segmentation_tpu``.

Two-stage PDE-regularised U-Net training for cell segmentation on an
NVIDIA GPU: the same model, objective, metrics, optimizers and pipeline
as the JAX package, with the fused physics-loss kernel and the fused
AdamW written by hand in CUDA (``csrc/physics_sums.cu``,
``csrc/adamw.cu``), and train-state checkpoints with resume.  The
``parallel`` subpackage trains data- and space-parallel over
``torch.distributed`` (NCCL on the GPU, gloo on the CPU), with the
halo-padded physics kernel in CUDA (``csrc/padded_physics.cu``).
``serve`` and ``predict`` apply a trained model to new images, and
``utils.conv_probe`` times the hand-written 3x3 convolution
(``csrc/conv3x3.cu``) against cuDNN's.  ``experiments`` runs the
ablation studies and the statistical model comparison (CLIs ``evaluate``
and ``run_ablation``).  Entry points run on CUDA unless they are given
``device="cpu"``.
"""

from .models import UNet, count_parameters  # noqa: F401
from .train import LossConfig, make_loss_and_components, train  # noqa: F401

__version__ = "0.1.0"

__all__ = ["UNet", "count_parameters", "LossConfig", "make_loss_and_components", "train"]
