"""Experiment orchestration: ablation variants and studies, model comparisons."""

from .ablation import (  # noqa: F401
    AblationConfig,
    create_ablation_loss_config,
    run_ablation_study,
    run_ablation_variant,
)
from .compare import (  # noqa: F401
    evaluate_and_compare,
    load_unet_params,
    make_json_serializable,
    run_repeated_evaluations,
)
from .studies import (  # noqa: F401
    ALL_STUDIES,
    define_ablation_r1,
    define_ablation_r2,
    define_ablation_r3,
    define_ablation_s1,
    define_ablation_s2,
    define_ablation_s3,
)

__all__ = [
    "AblationConfig",
    "create_ablation_loss_config",
    "run_ablation_variant",
    "run_ablation_study",
    "evaluate_and_compare",
    "run_repeated_evaluations",
    "load_unet_params",
    "make_json_serializable",
    "ALL_STUDIES",
    "define_ablation_r1",
    "define_ablation_r2",
    "define_ablation_r3",
    "define_ablation_s1",
    "define_ablation_s2",
    "define_ablation_s3",
]
