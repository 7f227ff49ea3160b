"""Experiment orchestration: ablation variants and studies, batched sweeps, model
comparisons."""

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
from .sweep import (  # noqa: F401
    run_batched_study,
    run_batched_sweep,
    sweep_scalars_from_variants,
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
    "run_batched_sweep",
    "run_batched_study",
    "sweep_scalars_from_variants",
    "ALL_STUDIES",
    "define_ablation_r1",
    "define_ablation_r2",
    "define_ablation_r3",
    "define_ablation_s1",
    "define_ablation_s2",
    "define_ablation_s3",
]
