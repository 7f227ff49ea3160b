"""Study definitions R1–R3, S1–S3: the port's copy of the JAX package's
``experiments/studies.py`` (the same names, descriptions and fields).

  R1 — PDE component ablation @ 100% data,
  R2 — data fractions {0.1, 0.25, 0.5, 0.75, 1.0} with the full model,
  R3 — PDE component ablation @ 10% data,
  S1 — reaction threshold a ∈ {0.3..0.7} @ 10% data,
  S2 — diffusion D ∈ {0.5, 1, 2, 5, 10, 100}, λ_RD = 1e-3, no PF, @ 10%,
  S3 — interface width ε ∈ {0.001, 0.01, 0.05, 0.1, 0.2} @ 10%.
"""

from __future__ import annotations

from .ablation import AblationConfig

__all__ = [
    "define_ablation_r1",
    "define_ablation_r2",
    "define_ablation_r3",
    "define_ablation_s1",
    "define_ablation_s2",
    "define_ablation_s3",
    "ALL_STUDIES",
]

_FULL = dict(
    use_pde=True,
    pde_weight=1e-4,
    phase_field_weight=1e-4,
    diffusion_coeff=5.0,
    reaction_threshold=0.5,
    epsilon=0.05,
    use_two_stage=True,
)


def _component_ablation(prefix: str, fraction) -> list:
    extra = {"train_fraction": fraction} if fraction is not None else {}
    suffix = " with 10% data" if fraction is not None else ""
    return [
        AblationConfig(
            name=f"{prefix}.0 Baseline",
            description=f"Baseline UNet (Dice + BCE only, no PDE constraints){suffix}",
            use_pde=False,
            pde_weight=0.0,
            phase_field_weight=0.0,
            use_two_stage=False,
            **extra,
        ),
        AblationConfig(
            name=f"{prefix}.1 RD Only",
            description=f"Reaction-Diffusion PDE only (λ_RD=1e-4, λ_PF=0.0){suffix}",
            **{**_FULL, "phase_field_weight": 0.0},
            **extra,
        ),
        AblationConfig(
            name=f"{prefix}.2 Phase-Field Only",
            description=f"Phase-field energy only (λ_RD=0.0, λ_PF=1e-4){suffix}",
            **{**_FULL, "pde_weight": 0.0},
            **extra,
        ),
        AblationConfig(
            name=f"{prefix}.3 RD + Phase-Field",
            description=f"Reaction-Diffusion + Phase-Field (λ_RD=1e-4, λ_PF=1e-4){suffix}",
            **_FULL,
            **extra,
        ),
    ]


def define_ablation_r1() -> list:
    """R1: PDE component ablation at 100% data."""
    return _component_ablation("R1", None)


def define_ablation_r3() -> list:
    """R3: PDE component ablation at 10% data."""
    return _component_ablation("R3", 0.1)


def define_ablation_r2() -> list:
    """R2: low-sample regime, full model."""
    fractions = [0.1, 0.25, 0.5, 0.75, 1.0]
    return [
        AblationConfig(
            name=f"R2.{i} {int(f * 100)}% Data",
            description=f"Full model (RD + Phase-Field) with {int(f * 100)}% training data",
            train_fraction=f,
            **_FULL,
        )
        for i, f in enumerate(fractions)
    ]


def define_ablation_s1() -> list:
    """S1: reaction threshold sensitivity."""
    return [
        AblationConfig(
            name=f"S1.{i} a={a:.1f}",
            description=f"Full model (RD + Phase-Field) with reaction threshold a={a}",
            train_fraction=0.1,
            **{**_FULL, "reaction_threshold": a},
        )
        for i, a in enumerate([0.3, 0.4, 0.5, 0.6, 0.7])
    ]


def define_ablation_s2() -> list:
    """S2: diffusion coefficient sensitivity."""
    return [
        AblationConfig(
            name=f"S2.{i} D={d:.1f}" if d < 10 else f"S2.{i} D={d:.0f}",
            description=f"Reaction-diffusion with diffusion coefficient D={d}",
            use_pde=True,
            pde_weight=1e-3,
            diffusion_coeff=d,
            phase_field_weight=0.0,
            train_fraction=0.1,
            use_two_stage=True,
        )
        for i, d in enumerate([0.5, 1.0, 2.0, 5.0, 10.0, 100.0])
    ]


def define_ablation_s3() -> list:
    """S3: interface width sensitivity."""
    return [
        AblationConfig(
            name=f"S3.{i} ε={e:.3f}" if e < 0.01 else f"S3.{i} ε={e:.2f}",
            description=(
                f"Reaction-diffusion + phase-field (ε={e}, λ_RD=1e-4, "
                "λ_PF=1e-4, D=5.0)"
            ),
            train_fraction=0.1,
            **{**_FULL, "epsilon": e},
        )
        for i, e in enumerate([0.001, 0.01, 0.05, 0.1, 0.2])
    ]


ALL_STUDIES = {
    "R1": define_ablation_r1,
    "R2": define_ablation_r2,
    "R3": define_ablation_r3,
    "S1": define_ablation_s1,
    "S2": define_ablation_s2,
    "S3": define_ablation_s3,
}
