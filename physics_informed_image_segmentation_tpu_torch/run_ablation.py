"""Ablation CLI of the PyTorch port:
``python -m physics_informed_image_segmentation_tpu_torch.run_ablation``.

Takes the flags of the repository's ``run_ablation.py`` (names, defaults
and help strings) plus ``--device`` (CUDA by default).  Runs the R1–R3 /
S1–S3 studies (or ``all``) with the deprecated ``--test-dir`` /
``--test-json`` aliasing onto the in-distribution split, and
``--resume [STUDY_DIR]`` to continue an interrupted study.
``--physics-backend`` takes ``auto`` (the CUDA kernel on the GPU),
``cuda`` or ``torch``.  ``--batched`` runs the S1–S3 studies through the
batched sweep (:func:`.experiments.run_batched_study`: one shared Stage I,
then every member's Stage II in one stack) and the R studies through the
serial runner; it does not combine with ``--resume``.
"""

import argparse
from pathlib import Path

from .experiments import ALL_STUDIES, run_ablation_study, run_batched_study
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run ablation studies for PDE-constrained cell segmentation (PyTorch/CUDA)"
    )
    parser.add_argument(
        "--ablation", type=str, required=True,
        choices=["R1", "R2", "R3", "S1", "S2", "S3", "all"],
        help='Which ablation study to run. "all" runs all ablation studies.',
    )
    parser.add_argument("--train-dir", type=str, default="images/training")
    parser.add_argument(
        "--train-json", type=str, default="images/annotation/training_annotation.json"
    )
    parser.add_argument("--val-dir", type=str, default="images/validation")
    parser.add_argument(
        "--val-json", type=str, default="images/annotation/validation_annotation.json"
    )
    parser.add_argument(
        "--test-dir", type=str, default="images/testing",
        help="[DEPRECATED] Use --in-dist-test-dir and --out-dist-test-dir instead",
    )
    parser.add_argument(
        "--test-json", type=str,
        default="images/annotation/testing_annotation.json",
        help="[DEPRECATED] Use --in-dist-test-json and --out-dist-test-json instead",
    )
    parser.add_argument("--in-dist-test-dir", type=str, default="images/in_dist_testing")
    parser.add_argument(
        "--in-dist-test-json", type=str,
        default="images/annotation/in_dist_testing_annotation.json",
    )
    parser.add_argument("--out-dist-test-dir", type=str, default="images/out_dist_testing")
    parser.add_argument(
        "--out-dist-test-json", type=str,
        default="images/annotation/out_dist_testing_annotation.json",
    )
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--stage1-epochs", type=int, default=50)
    parser.add_argument("--stage2-epochs", type=int, default=50)
    parser.add_argument("--early-stopping-patience", type=int, default=10)
    parser.add_argument(
        "--output-dir", type=str, default=None,
        help="Root for output/ablation/{name}_{timestamp}/ folders",
    )
    parser.add_argument(
        "--precision", type=str, default="bf16", choices=["bf16", "f32"]
    )
    parser.add_argument(
        "--physics-backend", type=str, default="auto", choices=["auto", "cuda", "torch"],
        help="Physics loss implementation (default: auto = the CUDA kernel on the GPU)",
    )
    parser.add_argument(
        "--base-channels", type=int, default=64,
        help="U-Net base channel count (default: 64, the reference architecture)",
    )
    parser.add_argument(
        "--batched", action="store_true",
        help="Run S1-S3 sensitivity grids as one batched stack of members",
    )
    parser.add_argument(
        "--resume", type=str, nargs="?", const="latest", default=None,
        metavar="STUDY_DIR",
        help="Resume an interrupted study: completed variants (their "
             "{stem}_results.json exists) are loaded, only missing "
             "variants retrain.  Pass the study folder, or no value to "
             "pick the latest {name}_* folder under the output root.",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device to train on (default: cuda; 'cpu' runs the plain PyTorch path)",
    )
    return parser


def _resume_folder(parser, args, ablation_name: str):
    """The study folder ``--resume`` names: the given one, or the latest
    ``{name}_*`` under the output root (``None`` for a study that an
    ``all`` run never reached)."""
    if args.resume != "latest":
        return Path(args.resume).resolve()
    root = Path(args.output_dir).resolve() if args.output_dir else Path.cwd() / "output" / "ablation"
    candidates = sorted(root.glob(f"{ablation_name}_*"), key=lambda p: p.stat().st_mtime)
    if candidates:
        return candidates[-1]
    if args.ablation != "all":
        parser.error(f"--resume: no {ablation_name}_* study folder under {root}")
    # an `all` run killed mid-sequence has no folder yet for the studies
    # it never reached: start those fresh
    print(f"[resume] no {ablation_name}_* folder under {root} — starting fresh")
    return None


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.resume is not None and args.batched:
        parser.error("--resume applies to the serial study runner, not --batched")
    device = resolve_device(args.device)

    in_dist_test_dir = Path(args.in_dist_test_dir).resolve()
    in_dist_test_json = Path(args.in_dist_test_json).resolve()
    # the deprecated flags name the in-distribution test set
    if (
        args.test_dir != "images/testing"
        or args.test_json != "images/annotation/testing_annotation.json"
    ):
        print(
            "Warning: --test-dir and --test-json are deprecated. "
            "Using them as in-distribution test set."
        )
        in_dist_test_dir = Path(args.test_dir).resolve()
        in_dist_test_json = Path(args.test_json).resolve()

    studies_to_run = (
        ["R1", "R2", "R3", "S1", "S2", "S3"] if args.ablation == "all" else [args.ablation]
    )

    for ablation_name in studies_to_run:
        variants = ALL_STUDIES[ablation_name]()
        print(f"\n{'=' * 70}")
        print(f"Starting Ablation Study: {ablation_name}")
        print(f"{'=' * 70}")

        study_args = dict(
            train_dir=Path(args.train_dir).resolve(),
            train_json=Path(args.train_json).resolve(),
            val_dir=Path(args.val_dir).resolve(),
            val_json=Path(args.val_json).resolve(),
            in_dist_test_dir=in_dist_test_dir,
            in_dist_test_json=in_dist_test_json,
            out_dist_test_dir=Path(args.out_dist_test_dir).resolve(),
            out_dist_test_json=Path(args.out_dist_test_json).resolve(),
            batch_size=args.batch_size,
            learning_rate=args.learning_rate,
            stage1_epochs=args.stage1_epochs,
            stage2_epochs=args.stage2_epochs,
            early_stopping_patience=args.early_stopping_patience,
            output_dir=Path(args.output_dir).resolve() if args.output_dir else None,
            precision=args.precision,
            physics_backend=args.physics_backend,
            base_channels=args.base_channels,
            device=device,
        )
        if args.batched and ablation_name in ("S1", "S2", "S3"):
            results = run_batched_study(ablation_name=ablation_name, variants=variants,
                                        **study_args)
        else:
            resume_from = None
            if args.resume is not None:
                resume_from = _resume_folder(parser, args, ablation_name)
                if resume_from is not None:
                    print(f"Resuming study from: {resume_from}")
            results = run_ablation_study(ablation_name=ablation_name, variants=variants,
                                         resume_from=resume_from, **study_args)

        print(f"\nAblation {ablation_name} complete!")
        print(f"Results: {results['results_json']}")
        print(f"Summary: {results['summary_csv']}")

    print("\n" + "=" * 70)
    print("ALL ABLATION STUDIES COMPLETE")
    print("=" * 70)


if __name__ == "__main__":
    main()
