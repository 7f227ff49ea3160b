"""Training engine and orchestration."""

from .adamw_kernel import FusedAdamW, fused_adamw_  # noqa: F401
from .checkpoint import (  # noqa: F401
    latest_checkpoint_step,
    load_params,
    restore_train_state,
    save_params,
    save_train_state,
)
from .csvlog import EPOCH_CSV_FIELDS, save_metrics_to_csv, save_test_metrics  # noqa: F401
from .engine import (  # noqa: F401
    EarlyStopping,
    TrainState,
    create_train_state,
    make_eval_epoch_fn,
    make_train_chunk_fn,
    make_train_epoch_fn,
    make_train_epochs_fn,
    make_train_step_fn,
    train_stage,
    tree_params,
)
from .evaluation import evaluate_model, evaluate_on_dataset, validate  # noqa: F401
from .loop import load_device_dataset, train  # noqa: F401
from .objective import LossConfig, make_loss_and_components  # noqa: F401
from .optim import AdamW, FlatAdamW, GroupedAdamW, LowPrecisionAdamW  # noqa: F401

__all__ = [
    "train",
    "train_stage",
    "TrainState",
    "create_train_state",
    "tree_params",
    "make_train_step_fn",
    "make_train_epoch_fn",
    "make_train_epochs_fn",
    "make_train_chunk_fn",
    "make_eval_epoch_fn",
    "EarlyStopping",
    "LossConfig",
    "make_loss_and_components",
    "AdamW",
    "FlatAdamW",
    "GroupedAdamW",
    "LowPrecisionAdamW",
    "FusedAdamW",
    "fused_adamw_",
    "evaluate_model",
    "evaluate_on_dataset",
    "validate",
    "save_params",
    "load_params",
    "save_train_state",
    "restore_train_state",
    "latest_checkpoint_step",
    "save_metrics_to_csv",
    "save_test_metrics",
    "EPOCH_CSV_FIELDS",
    "load_device_dataset",
]
