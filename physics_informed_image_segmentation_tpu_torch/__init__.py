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

The top level holds the subpackages, the JAX package's top-level names and
the reference implementation's 31 public names (``compat``), each bound to
the port's counterpart.  Importing it loads neither matplotlib, PIL nor
SciPy: the functions that need them import them.
"""

from . import data, experiments, models, ops, parallel, train, utils  # noqa: F401
from .compat import (  # noqa: F401
    DiceBCELoss,
    DiceBCEPDELoss,
    PDERegularization,
    compute_boundary_f1,
    create_pde_regularization,
    evaluate_on_test_set,
)
from .data import CocoSegmentationSource as CellSegmentationDataset  # noqa: F401
from .experiments import (  # noqa: F401
    AblationConfig,
    evaluate_and_compare,
    run_ablation_study,
    run_ablation_variant,
    run_repeated_evaluations,
)
from .models import UNet, count_parameters, mish  # noqa: F401
from .ops.losses import dice_bce_loss, dice_bce_pde_loss  # noqa: F401
from .ops.metrics import (  # noqa: F401
    boundary_f1_per_sample,
    dice_score,
    dice_score_per_sample,
    extract_boundaries,
    hausdorff_distance_np,
    iou_score,
    iou_score_per_sample,
)
from .ops.pde import (  # noqa: F401
    laplacian,
    pde_residual,
    pde_residual_loss,
    phase_field_loss,
    reaction_term,
)
from .ops.stats import (  # noqa: F401
    compare_models_statistically,
    compute_statistics,
    format_metric_report,
)
from .train import (  # noqa: F401
    EarlyStopping,
    LossConfig,
    evaluate_model,
    evaluate_on_dataset,
    make_loss_and_components,
    train,
    train_stage,
    validate,
)
from .utils.plot import (  # noqa: F401
    plot_all_metrics,
    plot_training_curves,
    plot_training_results,
    plot_two_stage_comparison,
)

__version__ = "0.1.0"

# the reference implementation's function names for the same functions
compute_dice_score = dice_score
compute_dice_score_batch = dice_score_per_sample
compute_iou = iou_score
compute_iou_batch = iou_score_per_sample
compute_boundary_f1_batch = boundary_f1_per_sample
compute_hausdorff_distance = hausdorff_distance_np

__all__ = [
    # data
    "CellSegmentationDataset",
    # model
    "UNet",
    "mish",
    "count_parameters",
    # losses / physics
    "dice_bce_loss",
    "dice_bce_pde_loss",
    "LossConfig",
    "make_loss_and_components",
    "laplacian",
    "reaction_term",
    "pde_residual",
    "pde_residual_loss",
    "phase_field_loss",
    # metrics
    "dice_score",
    "dice_score_per_sample",
    "iou_score",
    "iou_score_per_sample",
    "boundary_f1_per_sample",
    "extract_boundaries",
    "hausdorff_distance_np",
    # training
    "train",
    "train_stage",
    "validate",
    "EarlyStopping",
    "evaluate_model",
    "evaluate_on_dataset",
    # statistics
    "compute_statistics",
    "compare_models_statistically",
    "format_metric_report",
    # experiments
    "AblationConfig",
    "run_ablation_variant",
    "run_ablation_study",
    "evaluate_and_compare",
    "run_repeated_evaluations",
    # plotting (matplotlib is imported when a plot is drawn)
    "plot_training_curves",
    "plot_two_stage_comparison",
    "plot_all_metrics",
    "plot_training_results",
    # the reference's names
    "compute_dice_score",
    "compute_dice_score_batch",
    "compute_iou",
    "compute_iou_batch",
    "compute_boundary_f1",
    "compute_boundary_f1_batch",
    "compute_hausdorff_distance",
    "DiceBCELoss",
    "DiceBCEPDELoss",
    "PDERegularization",
    "create_pde_regularization",
    "evaluate_on_test_set",
]
