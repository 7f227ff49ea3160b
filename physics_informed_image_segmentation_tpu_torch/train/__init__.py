"""Training engine and orchestration."""

from .checkpoint import load_params, save_params  # noqa: F401
from .csvlog import EPOCH_CSV_FIELDS, save_metrics_to_csv, save_test_metrics  # noqa: F401
from .engine import (  # noqa: F401
    EarlyStopping,
    TrainState,
    create_train_state,
    make_eval_epoch_fn,
    make_train_epoch_fn,
    make_train_step_fn,
    train_stage,
)
from .evaluation import evaluate_model, evaluate_on_dataset, validate  # noqa: F401
from .loop import load_device_dataset, train  # noqa: F401
from .objective import LossConfig, make_loss_and_components  # noqa: F401
from .optim import AdamW  # noqa: F401

__all__ = [
    "train",
    "train_stage",
    "TrainState",
    "create_train_state",
    "make_train_step_fn",
    "make_train_epoch_fn",
    "make_eval_epoch_fn",
    "EarlyStopping",
    "LossConfig",
    "make_loss_and_components",
    "AdamW",
    "evaluate_model",
    "evaluate_on_dataset",
    "validate",
    "save_params",
    "load_params",
    "save_metrics_to_csv",
    "save_test_metrics",
    "EPOCH_CSV_FIELDS",
    "load_device_dataset",
]
