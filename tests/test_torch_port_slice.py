"""PyTorch port: the training entry points end to end on the CPU, the CLI,
the port's isolation from JAX, and the absence of any silent CPU fallback.
"""

import ast
import csv
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.train.csvlog import EPOCH_CSV_FIELDS as JAX_FIELDS
from physics_informed_image_segmentation_tpu_torch.data import (
    DeviceDataset,
    make_blobs,
    write_synthetic_coco,
)
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.train import (
    EPOCH_CSV_FIELDS,
    LossConfig,
    load_params,
    save_metrics_to_csv,
    train,
    validate,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "physics_informed_image_segmentation_tpu_torch"
JAX_PKG = "physics_informed_image_segmentation_tpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


def _splits(n_train=6, n_val=3, n_test=3, hw=32):
    images, masks = make_blobs(n_train + n_val + n_test, hw, hw, seed=0)
    cut = lambda a, b: DeviceDataset.from_numpy(images[a:b], masks[a:b], "cpu")
    return dict(train_data=cut(0, n_train), val_data=cut(n_train, n_train + n_val),
                test_data=cut(n_train + n_val, n_train + n_val + n_test))


def test_train_end_to_end_on_cpu(tmp_path):
    res = train(stage1_epochs=2, stage2_epochs=2, batch_size=4, base_channels=4,
                precision="f32", make_plots=False, verbose=False, device="cpu",
                output_dir=tmp_path / "out", models_dir=tmp_path / "models", **_splits())
    header = ",".join(JAX_FIELDS) + "\r\n"
    for key in ("stage1_csv", "stage2_csv"):
        with open(res[key], newline="") as f:
            assert f.readline() == header
        with open(res[key], newline="") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) >= 1 and all(np.isfinite(float(v)) for r in rows for v in r.values())
    assert float(rows[0]["train_pde_loss"]) > 0
    for key in ("baseline_model", "pde_model"):
        model = load_params(res[key], UNet(base_channels=4))
        assert isinstance(model, UNet)
    metrics = res["test_metrics_stage2"]
    assert set(metrics) == {"dice_scores", "iou_scores", "boundary_f1_scores",
                            "hausdorff_distances"}
    assert len(metrics["hausdorff_distances"]) == 3
    assert sorted(p.suffix for p in (tmp_path / "out").glob("test_metrics_*")) == \
        [".csv", ".csv", ".json", ".json"]


def test_single_stage_with_train_fraction(tmp_path):
    res = train(use_two_stage=False, stage1_epochs=1, batch_size=4, base_channels=4,
                precision="f32", make_plots=False, verbose=False, device="cpu",
                train_fraction=0.5, output_dir=tmp_path, models_dir=tmp_path, **_splits())
    assert "_frac0.50" in Path(res["single_csv"]).name
    assert len(res["test_metrics"]["dice_scores"]) == 3


def test_validate_reports_the_eval_epoch_metrics():
    data = _splits()["val_data"]
    res = validate(UNet(base_channels=4), data, LossConfig(pde_weight=1e-4), batch_size=2)
    assert {"loss", "dice_score", "per_sample_dice", "iou_score", "boundary_f1_score",
            "pde_loss"} <= set(res)
    assert all(np.isfinite(v) for v in res.values()) and res["pde_loss"] > 0


def test_training_plots_are_written(tmp_path):
    from physics_informed_image_segmentation_tpu_torch.utils.plot import plot_training_results

    rows = [{k: (e if k == "epoch" else 0.1 * e + i * 1e-3)
             for i, k in enumerate(EPOCH_CSV_FIELDS)} for e in (1, 2)]
    save_metrics_to_csv(rows, tmp_path / "metrics_stage1_x.csv")
    save_metrics_to_csv(rows, tmp_path / "metrics_stage2_x.csv")
    plot_training_results(tmp_path / "metrics_stage1_x.csv", tmp_path / "metrics_stage2_x.csv",
                          tmp_path / "plots")
    assert len(list((tmp_path / "plots").glob("*.png"))) == 6


def _write_reference_layout(root: Path, n=4):
    """images/{training,validation,testing}/ + images/annotation/*_annotation.json"""
    ann_dir = root / "images" / "annotation"
    ann_dir.mkdir(parents=True)
    for i, split in enumerate(("training", "validation", "testing")):
        img_dir, ann = write_synthetic_coco(root / "tmp" / split, n=n, height=40, width=48,
                                            seed=i)
        shutil.move(str(img_dir), root / "images" / split)
        shutil.move(str(ann), ann_dir / f"{split}_annotation.json")


def test_cli_trains_from_a_coco_layout(tmp_path):
    from physics_informed_image_segmentation_tpu_torch.__main__ import main

    _write_reference_layout(tmp_path)
    main(["--data-root", str(tmp_path), "--device", "cpu", "--base-channels", "4",
          "--stage1-epochs", "1", "--stage2-epochs", "1", "--batch-size", "4",
          "--precision", "f32", "--physics-backend", "torch", "--no-plots"])
    assert len(list((tmp_path / "output").glob("metrics_stage*_*.csv"))) == 2
    assert (tmp_path / "models" / "unet_pde_regularized.pth").exists()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = []
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            if root in FORBIDDEN or name == JAX_PKG or name.startswith(JAX_PKG + "."):
                bad.append(f"{path.relative_to(REPO)}: {name}")
    assert not bad, bad


def test_port_runs_without_jax_pil_matplotlib_pandas(tmp_path):
    """Import the port and train on the CPU with those modules made unimportable."""
    script = textwrap.dedent(f"""
        import sys
        for name in {FORBIDDEN + ("PIL", "matplotlib", "pandas")!r}:
            sys.modules[name] = None  # any import of these now raises ImportError
        sys.path.insert(0, {str(REPO)!r})
        import physics_informed_image_segmentation_tpu_torch as port
        from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs
        im, ms = make_blobs(4, 16, 16, seed=0)
        d = DeviceDataset.from_numpy(im, ms, "cpu")
        port.train(stage1_epochs=1, stage2_epochs=1, batch_size=4, base_channels=2,
                   precision="f32", make_plots=False, verbose=False, device="cpu",
                   train_data=d, val_data=d, output_dir={str(tmp_path)!r},
                   models_dir={str(tmp_path)!r})
        loaded = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}
                  and sys.modules[m] is not None]
        print("LOADED", loaded)
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


def test_no_hidden_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(stage1_epochs=1, stage2_epochs=1, base_channels=2, make_plots=False,
              verbose=False, output_dir=tmp_path, models_dir=tmp_path, **_splits(4, 2, 2, 16))
    from physics_informed_image_segmentation_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--data-root", str(tmp_path), "--no-plots"])
