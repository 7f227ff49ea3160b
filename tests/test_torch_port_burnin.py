"""PyTorch port: ``scripts/ablation_burnin.py`` (the counterpart of the JAX
repo's ``scripts/ablation_burnin.py``) on the CPU.

* Its dataset is the JAX script's, byte for byte: JAX
  ``write_synthetic_coco`` at the JAX script's ``SPLITS`` (seeds and
  recipes read from that script) gives the same PNGs and annotations.
* The port's ``run_ablation`` CLI (``--device cpu --base-channels 4
  --precision f32 --ablation R1``, 1+1 epochs, 6/3/3+3 images of 32x32) is
  SIGKILLed once R1 has written its first variant results JSON (1 to 3 of 4
  written at the kill), then resumed with ``--resume latest``; ``report``
  finds its aggregate bit-equal to an uninterrupted run's after the JAX
  script's ``_STRIP`` fields alone, and ``twice``'s gap helper reads 0.
* The kill trigger fails the subcommand when the process ends before the
  study writes a variant, and when the kill finds every variant written.
* ``report`` fails on an aggregate that differs in one metric value, and
  takes NaN at the same place as equal.
"""

import importlib.util
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from physics_informed_image_segmentation_tpu.data import write_synthetic_coco as jax_write
from physics_informed_image_segmentation_tpu_torch.scripts import ablation_burnin as burnin

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_ablation_burnin",
                                                  REPO / "scripts" / "ablation_burnin.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cpu_cfg(tmp_path, images=(6, 3, 3, 3), size=32) -> burnin.Burnin:
    return burnin.Burnin(data_root=tmp_path / "data", work=tmp_path / "work", ablation="R1",
                         images=images, size=size, epochs=1, base_channels=4,
                         precision="f32", device="cpu", launch="plain")


def test_dataset_is_the_jax_scripts_byte_for_byte(tmp_path):
    jax_script = _jax_script()
    assert burnin.SPLITS == jax_script.SPLITS
    assert burnin.STRIP == jax_script._STRIP
    cfg = _cpu_cfg(tmp_path, images=(3, 2, 2, 2), size=128)
    burnin.make_data(cfg)
    for (split, (_, seed, kw)), n in zip(jax_script.SPLITS.items(), cfg.images):
        image_dir, ann = jax_write(tmp_path / "jax" / split, n=n, height=128, width=128,
                                   seed=seed, **kw)
        ours = cfg.data_root / "images"
        assert (ours / "annotation" / f"{split}_annotation.json").read_bytes() == ann.read_bytes()
        names = sorted(p.name for p in image_dir.iterdir())
        assert names == sorted(p.name for p in (ours / split).iterdir()) and len(names) == n
        for name in names:
            assert (ours / split / name).read_bytes() == (image_dir / name).read_bytes(), name


def test_killed_and_resumed_study_equals_the_uninterrupted_one(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = _cpu_cfg(tmp_path)
    facts = {"card": "cpu"}
    burnin.make_data(cfg)
    cfg.work.mkdir()
    burnin.run_a(cfg, facts)
    b = burnin.run_b(cfg, facts)
    assert 1 <= b["variants_at_kill"] < 4
    # the killed process printed no launch counts; the resumed one did
    assert len(b["k1_launches"]) == 1
    line = burnin.report(cfg, facts)
    assert line["report"] == "1/1" and line["variants"] == {"R1": 4}
    a_agg, b_agg = (burnin.aggregates(cfg.work / r) for r in ("run_a", "run_b"))
    assert burnin.leaf_gap(a_agg, b_agg)[:2] == (0.0, 0)
    assert "1/1 study aggregate JSONs identical" in (cfg.work / "REPORT.md").read_text()


@pytest.mark.parametrize("written", [0, 4])
def test_the_kill_must_land_mid_study(tmp_path, written):
    folder = tmp_path / "output" / "ablation" / "R1_20260101_000000"
    folder.mkdir(parents=True)
    for i in range(written):
        (folder / f"v{i}_results.json").write_text("{}")
    code = "pass" if written == 0 else "import time; time.sleep(60)"
    p = subprocess.Popen([sys.executable, "-c", code])
    try:
        match = "never fired" if written == 0 else "not mid-study"
        with pytest.raises(RuntimeError, match=match):
            burnin.kill_mid_study(p, tmp_path, "R1", 4)
    finally:
        p.kill()
        p.wait()


def _fake_run(cfg, name, hausdorff):
    study = cfg.work / name / "output" / "ablation" / "R1_20260101_000000"
    study.mkdir(parents=True)
    results = [{"config": {"name": f"R1.{i}"}, "model_path": f"/{name}/m{i}.pth",
                "in_dist_metrics": {"dice_scores": [0.5, 0.25]}} for i in range(4)]
    agg = {"ablation_name": "R1", "results": results, "aggregated_results": {
        "R1.0": {"hausdorff_distances": {"mean": hausdorff, "values": [hausdorff]}}}}
    (study / "ablation_R1_20260101_000000.json").write_text(json.dumps(agg))


@pytest.mark.parametrize("b_value,equal", [(3.0, True), (3.0000000000000004, False),
                                           (math.nan, True)])
def test_report_holds_every_metric_bit_for_bit(tmp_path, b_value, equal):
    cfg = _cpu_cfg(tmp_path)
    _fake_run(cfg, "run_a", math.nan if math.isnan(b_value) else 3.0)
    _fake_run(cfg, "run_b", b_value)
    run = {"launch": "plain", "wall_s": 1.0, "started": "2026-01-01T00:00:00"}
    (cfg.work / "runs.json").write_text(json.dumps(
        {"run_a": run, "run_b": {**run, "killed_after_s": 0.5, "variants_at_kill": 1}}))
    if equal:
        assert burnin.report(cfg, {"card": "cpu"})["report"] == "1/1"
    else:
        with pytest.raises(RuntimeError, match="aggregate mismatch"):
            burnin.report(cfg, {"card": "cpu"})
        gap, differ, _ = burnin.leaf_gap(burnin.aggregates(cfg.work / "run_a"),
                                         burnin.aggregates(cfg.work / "run_b"))
        assert differ == 2 and gap == pytest.approx(4.4e-16, rel=0.1)
    shutil.rmtree(cfg.work)
