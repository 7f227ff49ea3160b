"""Train CLI of the PyTorch port: ``python -m physics_informed_image_segmentation_tpu_torch``.

Takes the flags of the repository's ``main.py`` (names, defaults and
help strings).  ``--physics-backend`` takes auto|cuda|torch and
``--device`` picks the device (CUDA by default).  To make a run
resumable, pass ``--checkpoint-every N``; after a crash, run the same
command again with ``--resume`` added.

NOTE on --early-stopping-patience: the CLI default is 5 while the help
text and train() say 10, as in ``main.py``.
"""

import argparse

from .models import MODELS
from .train import train


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train PDE-constrained cell segmentation model (PyTorch/CUDA)"
    )
    parser.add_argument(
        "--single-stage", action="store_true",
        help="Use single-stage training (PDE from start) instead of two-stage",
    )
    parser.add_argument(
        "--pde-weight", type=float, default=1e-4,
        help="Weight for PDE regularization λ_RD (default: 1e-4, optimal)",
    )
    parser.add_argument(
        "--diffusion-coeff", type=float, default=5.0,
        help="Diffusion coefficient D for PDE (default: 5.0, optimal)",
    )
    parser.add_argument(
        "--reaction-threshold", type=float, default=0.5,
        help="Reaction term threshold a for PDE (default: 0.5, optimal)",
    )
    parser.add_argument(
        "--phase-field-weight", type=float, default=1e-4,
        help="Weight for phase-field energy λ_PF (default: 1e-4, optimal)",
    )
    parser.add_argument(
        "--epsilon", type=float, default=0.05,
        help="Interface width parameter ε for phase-field energy (default: 0.05, optimal)",
    )
    parser.add_argument(
        "--batch-size", type=int, default=8,
        help="Batch size for training (default: 8, recommended: 8-16)",
    )
    parser.add_argument(
        "--learning-rate", type=float, default=1e-4,
        help="Learning rate for AdamW optimizer (default: 1e-4)",
    )
    parser.add_argument(
        "--stage1-epochs", type=int, default=50,
        help="Maximum epochs for Stage I (baseline training) (default: 50)",
    )
    parser.add_argument(
        "--stage2-epochs", type=int, default=50,
        help="Maximum epochs for Stage II (PDE fine-tuning) (default: 50)",
    )
    parser.add_argument(
        "--early-stopping-patience", type=int, default=5,
        help="Patience for early stopping (default: 10)",
    )
    parser.add_argument(
        "--train-fraction", type=float, default=None,
        help="Fraction of training data to use (e.g., 0.1 for 10%%, 0.25 for 25%%)",
    )
    parser.add_argument(
        "--seed", type=int, default=42,
        help="Random seed for reproducibility (default: 42)",
    )
    parser.add_argument(
        "--data-root", type=str, default=None,
        help="Root directory containing images/ (default: cwd)",
    )
    parser.add_argument(
        "--precision", type=str, default="bf16", choices=["bf16", "f32"],
        help="Compute precision for the model (default: bf16; f32 turns TF32 off)",
    )
    parser.add_argument(
        "--physics-backend", type=str, default="auto", choices=["auto", "cuda", "torch"],
        help="Physics loss implementation (default: auto = the CUDA kernel on the GPU)",
    )
    parser.add_argument("--no-plots", action="store_true", help="Skip plot generation")
    parser.add_argument(
        "--base-channels", type=int, default=64,
        help="U-Net base channel count (default: 64, the reference architecture)",
    )
    parser.add_argument(
        "--model", type=str, default="unet", choices=list(MODELS),
        help="Architecture (default: unet; transunet is R50-ViT-B/16 and swinunet Swin-Unet "
             "(Swin-T, window 7) at their published widths, built for the images' side, a "
             "multiple of 224 for swinunet)",
    )
    parser.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="Write a full train-state checkpoint every N epochs "
             "under {models}/checkpoints/ (default: 0 = off)",
    )
    parser.add_argument(
        "--checkpoint-keep", type=int, default=2,
        help="Retain only the newest N train-state checkpoints per stage "
             "(default: 2; 0 = keep all — each is ~250 MB at base-channels 64)",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="Continue an interrupted run in the same output/models dirs: "
             "completed stages are skipped, a partial stage restarts from "
             "its latest checkpoint and continues its CSV in place "
             "(bit-identical to an uninterrupted run at equal precision)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device to train on (default: cuda; 'cpu' runs the plain PyTorch path)",
    )
    args = parser.parse_args(argv)

    train(
        use_two_stage=not args.single_stage,
        pde_weight=args.pde_weight,
        diffusion_coeff=args.diffusion_coeff,
        reaction_threshold=args.reaction_threshold,
        phase_field_weight=args.phase_field_weight,
        epsilon=args.epsilon,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        stage1_epochs=args.stage1_epochs,
        stage2_epochs=args.stage2_epochs,
        early_stopping_patience=args.early_stopping_patience,
        train_fraction=args.train_fraction,
        seed=args.seed,
        data_root=args.data_root,
        precision=args.precision,
        physics_backend=args.physics_backend,
        make_plots=not args.no_plots,
        base_channels=args.base_channels,
        model_name=args.model,
        checkpoint_every=args.checkpoint_every,
        checkpoint_keep=args.checkpoint_keep or None,
        resume=args.resume,
        device=args.device,
    )


if __name__ == "__main__":
    main()
