"""Evaluation CLI of the PyTorch port:
``python -m physics_informed_image_segmentation_tpu_torch.evaluate``.

Takes the flags of the repository's ``evaluate.py`` (names, defaults and
help strings) plus ``--device`` (CUDA by default).  Three modes:

    # compare two checkpoints (bf16 evaluation)
    python -m physics_informed_image_segmentation_tpu_torch.evaluate \\
        --baseline models/unet_baseline.pth --pde models/unet_pde_regularized.pth
    # pool seed-paired checkpoints matched by glob patterns
    python -m physics_informed_image_segmentation_tpu_torch.evaluate \\
        --baseline 'out/*baseline*.pth' --pde 'out/*pde*.pth' --repeated
    # one checkpoint, no comparison (float32 evaluation):
    # writes single_model_metrics_{stem}.json
    python -m physics_informed_image_segmentation_tpu_torch.evaluate \\
        --model-path models/unet_pde_regularized.pth
"""

import argparse
import json
from glob import glob
from pathlib import Path

from .experiments.compare import (
    evaluate_and_compare,
    load_unet_params,
    make_json_serializable,
    run_repeated_evaluations,
)
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate and compare segmentation models (PyTorch/CUDA)"
    )
    parser.add_argument(
        "--baseline", type=str, default=None,
        help="Path to baseline model checkpoint (or pattern for repeated experiments)",
    )
    parser.add_argument(
        "--pde", type=str, default=None,
        help="Path to PDE-constrained model checkpoint (or pattern for repeated experiments)",
    )
    parser.add_argument(
        "--model-path", type=str, default=None,
        help="Evaluate a SINGLE checkpoint on the test set (no comparison); "
        "the usage documented in the reference README",
    )
    parser.add_argument(
        "--test-dir", type=str, default="images/testing",
        help="Directory containing test images (default: images/testing)",
    )
    parser.add_argument(
        "--test-json", type=str,
        default="images/annotation/testing_annotation.json",
        help="Path to test annotations JSON",
    )
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument(
        "--threshold", type=float, default=0.5,
        help="Threshold for binarizing predictions (default: 0.5)",
    )
    parser.add_argument(
        "--output-dir", type=str, default="output",
        help="Directory to save evaluation results (default: output)",
    )
    parser.add_argument(
        "--base-channels", type=int, default=64,
        help="U-Net base channel count of the checkpoints (default: 64)",
    )
    parser.add_argument(
        "--repeated", action="store_true",
        help="Run repeated experiments evaluation (baseline and pde are glob patterns)",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Device to evaluate on (default: cuda; 'cpu' runs on the host)",
    )
    return parser


def _evaluate_single(model_path: Path, args, device) -> None:
    """One checkpoint in float32: the metrics report and
    ``single_model_metrics_{stem}.json`` (statistics and per-image values)."""
    from .ops.stats import compute_statistics
    from .train.evaluation import evaluate_on_dataset
    from .train.loop import load_device_dataset

    model, _ = load_unet_params(model_path, base_channels=args.base_channels, precision="f32",
                                device=device)
    data = load_device_dataset(args.test_dir, args.test_json, device)
    metrics = evaluate_on_dataset(model, data, batch_size=args.batch_size,
                                  model_name=model_path.stem, threshold=args.threshold,
                                  precision="f32")
    output_dir = Path(args.output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        name: {"statistics": compute_statistics(values), "per_image": list(values)}
        for name, values in metrics.items()
    }
    out_json = output_dir / f"single_model_metrics_{model_path.stem}.json"
    with open(out_json, "w") as f:
        json.dump(make_json_serializable(payload), f, indent=2)
    print(f"\nPer-image metrics saved to: {out_json}")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.model_path is None and (args.baseline is None or args.pde is None):
        parser.error("either --model-path or both --baseline and --pde are required")
    if args.model_path is not None and (args.baseline or args.pde):
        parser.error("--model-path is mutually exclusive with --baseline/--pde")
    device = resolve_device(args.device)

    test_dir = Path(args.test_dir)
    test_json = Path(args.test_json)
    output_dir = Path(args.output_dir)

    if args.model_path:
        model_path = Path(args.model_path)
        if not model_path.exists():
            print(f"Error: Model not found: {model_path}")
            return
        _evaluate_single(model_path, args, device)
    elif args.repeated:
        baseline_paths = sorted(glob(args.baseline))
        pde_paths = sorted(glob(args.pde))
        if len(baseline_paths) == 0:
            print(f"Error: No baseline models found matching pattern: {args.baseline}")
            return
        if len(pde_paths) == 0:
            print(f"Error: No PDE models found matching pattern: {args.pde}")
            return
        if len(baseline_paths) != len(pde_paths):
            print(
                f"Warning: Number of baseline models ({len(baseline_paths)}) != "
                f"number of PDE models ({len(pde_paths)})"
            )
        print(f"\nFound {len(baseline_paths)} baseline models")
        print(f"Found {len(pde_paths)} PDE-constrained models")
        run_repeated_evaluations(
            baseline_model_paths=[Path(p) for p in baseline_paths],
            pde_model_paths=[Path(p) for p in pde_paths],
            test_dir=test_dir,
            test_json=test_json,
            batch_size=args.batch_size,
            threshold=args.threshold,
            output_dir=output_dir,
            base_channels=args.base_channels,
            device=device,
        )
    else:
        baseline_path = Path(args.baseline)
        pde_path = Path(args.pde)
        if not baseline_path.exists():
            print(f"Error: Baseline model not found: {baseline_path}")
            return
        if not pde_path.exists():
            print(f"Error: PDE model not found: {pde_path}")
            return
        evaluate_and_compare(
            baseline_model_path=baseline_path,
            pde_model_path=pde_path,
            test_dir=test_dir,
            test_json=test_json,
            batch_size=args.batch_size,
            threshold=args.threshold,
            output_dir=output_dir,
            base_channels=args.base_channels,
            device=device,
        )

    print("\n" + "=" * 70)
    print("EVALUATION COMPLETE")
    print("=" * 70)


if __name__ == "__main__":
    main()
