"""PyTorch port: train-state checkpoints and resume, mirroring the JAX
package's tests of them (tests/test_engine.py, test_train_integration.py,
test_cli.py).

Everything here is the port against itself on the CPU: a resumed stage or
run must be bit-identical to an uninterrupted one (exact equality, no
tolerance), with dropout on and a shuffled plan, because the shuffle is
seeded per epoch and the dropout generator's state is checkpointed.
"""

import csv
import os
import shutil
import time

import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu_torch.__main__ import main as cli_main
from physics_informed_image_segmentation_tpu_torch.data import (
    DeviceDataset,
    make_blobs,
    write_synthetic_coco,
)
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.train import (
    EarlyStopping,
    LossConfig,
    create_train_state,
    latest_checkpoint_step,
    load_params,
    make_eval_epoch_fn,
    make_train_epoch_fn,
    restore_train_state,
    save_train_state,
    train,
    train_stage,
)
from physics_informed_image_segmentation_tpu_torch.train.loop import (
    _read_metric_rows,
    _stage_resume,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    images, masks = make_blobs(8, 32, 32, seed=0)
    return DeviceDataset.from_numpy(images, masks, "cpu")


def _fresh(optimizer="adamw", seed=0):
    """A new model and train state; other seeds give other weights and
    another dropout stream, which a restore must overwrite."""
    model = UNet(base_channels=4, generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, 1e-3, optimizer=optimizer, dropout_seed=seed)


def _stage(state, data, num_epochs, csv_path=None, **kw):
    cfg = LossConfig(pde_weight=1e-4, phase_field_weight=1e-4)
    return train_stage(state, make_train_epoch_fn(cfg), make_eval_epoch_fn(cfg), data, data,
                       batch_size=3, num_epochs=num_epochs, stage_name="T", shuffle_seed=7,
                       verbose=False, csv_path=csv_path, **kw)


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(list(a.model.parameters()) + a.optimizer.m + a.optimizer.v,
                    list(b.model.parameters()) + b.optimizer.m + b.optimizer.v):
        assert torch.equal(x, y)
    assert torch.equal(a.dropout_generator.get_state(), b.dropout_generator.get_state())


def test_save_train_state_retention_ignores_leftovers(tmp_path):
    state = _fresh()
    for step in (1, 2, 3, 4):
        save_train_state(state, tmp_path, step=step, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3", "step_4"]
    leftover = tmp_path / "step_9.tmp-123"  # an interrupted save
    leftover.write_bytes(b"partial")
    assert latest_checkpoint_step(tmp_path) == 4
    save_train_state(state, tmp_path, step=5, keep=2)
    assert latest_checkpoint_step(tmp_path) == 5 and leftover.exists()
    leftover.unlink()
    save_train_state(state, tmp_path, step=6)  # keep=None retains everything
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4", "step_5", "step_6"]
    assert latest_checkpoint_step(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError):
        restore_train_state(_fresh(), tmp_path / "missing")


def test_periodic_checkpoints_written_and_restorable(data, tmp_path):
    state, _, _, _ = _stage(_fresh(), data, 3, checkpoint_dir=tmp_path, checkpoint_every=1)
    assert latest_checkpoint_step(tmp_path) == state.step == 9
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_6", "step_9"]  # keep=2
    restored = restore_train_state(_fresh(seed=123), tmp_path)
    _assert_states_equal(state, restored)


def test_checkpoint_every_n_and_the_last_epoch(data, tmp_path):
    _stage(_fresh(), data, 3, checkpoint_dir=tmp_path, checkpoint_every=2, checkpoint_keep=None)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_6", "step_9"]


@pytest.mark.parametrize("optimizer", ["adamw", "pallas_adamw"])
def test_resumed_stage_bit_identical(data, tmp_path, optimizer):
    # oracle: 5 uninterrupted epochs
    s_a, best_a, be_a, rows_a = _stage(_fresh(optimizer), data, 5, tmp_path / "a.csv")
    # "interrupted": 3 epochs with per-epoch checkpoints
    ck = tmp_path / "ck"
    _, _, _, rows_b = _stage(_fresh(optimizer), data, 3, tmp_path / "b.csv",
                             checkpoint_dir=ck, checkpoint_every=1)
    # resume from the checkpoint into a fresh state, replaying the 3 rows
    restored = restore_train_state(_fresh(optimizer, seed=99), ck)
    s_c, best_c, be_c, rows_c = _stage(restored, data, 5, tmp_path / "b.csv",
                                       initial_metrics=rows_b)
    assert [r["epoch"] for r in rows_c] == [1, 2, 3, 4, 5]
    assert rows_c == rows_a
    assert be_c == be_a and best_c["val"]["dice_score"] == best_a["val"]["dice_score"]
    _assert_states_equal(s_a, s_c)
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()


def test_replay_stops_when_early_stopping_already_fired(data, tmp_path):
    rows = [{"epoch": e, "val_dice_score": 0.5, "train_loss": 1.0, "val_loss": 1.0}
            for e in (1, 2, 3)]
    es = EarlyStopping(patience=2, min_delta=1e-4, mode="max")
    state = _fresh()
    out, best, best_epoch, all_rows = _stage(state, data, 10, tmp_path / "r.csv",
                                             early_stopping=es, initial_metrics=rows)
    assert len(all_rows) == 3 and es.early_stop and best_epoch == 1
    assert out.step == 0  # no new epoch ran
    assert best == {"train": {"loss": 1.0}, "val": {"dice_score": 0.5, "loss": 1.0}}


def test_save_best_path_and_epoch_callback(data, tmp_path):
    seen = []
    state, _, best_epoch, _ = _stage(_fresh(), data, 2, save_best_path=tmp_path / "best.pth",
                                     epoch_callback=lambda e, row: seen.append((e, row["epoch"])))
    assert seen == [(1, 1), (2, 2)]
    if best_epoch:
        assert isinstance(load_params(tmp_path / "best.pth", UNet(base_channels=4)), UNet)


def _write_csv(path, rows, truncate_last=False):
    lines = ["epoch,val_dice_score,train_loss"] + [f"{e},{d},1.0" for e, d in rows]
    if truncate_last:
        lines.append("9,0.9")  # a crash in the middle of a rewrite
    path.write_text("\n".join(lines) + "\n")


def test_truncated_trailing_row_dropped(tmp_path):
    p = tmp_path / "metrics_stage1_x.csv"
    _write_csv(p, [(1, 0.5), (2, 0.6)], truncate_last=True)
    assert [r["epoch"] for r in _read_metric_rows(p)] == [1, 2]


def _resume_plan(state, tmp_path, csv_glob, **kw):
    args = dict(output_dir=tmp_path, csv_glob=csv_glob, checkpoint_dir=None,
                final_artifact=None, steps_per_epoch=3, num_epochs=12, patience=5,
                verbose=False)
    args.update(kw)
    return _stage_resume(state, **args)


def test_stale_final_artifact_ignored(tmp_path):
    """A final artifact beside a partial CSV (no early stop, fewer rows than
    the stage's epochs) is a leftover of an older run."""
    state = _fresh()
    _write_csv(tmp_path / "metrics_stage1_new.csv", [(1, 0.50), (2, 0.55), (3, 0.60)])
    artifact = tmp_path / "unet_baseline.pth"
    artifact.write_bytes(b"stale")  # never read on this path
    out, rows, csv_path = _resume_plan(state, tmp_path, "metrics_stage1_*.csv",
                                       final_artifact=artifact)
    assert rows is None and csv_path is None and out is state


def test_early_stopped_stage_counts_complete(tmp_path):
    from physics_informed_image_segmentation_tpu_torch.train import save_params

    state = _fresh()
    csv_p = tmp_path / "metrics_stage1_es.csv"
    _write_csv(csv_p, [(1, 0.70), (2, 0.69), (3, 0.68)])  # stopped with patience 2
    other = _fresh(seed=5)
    save_params(other.model, tmp_path / "unet_baseline.pth")
    out, rows, csv_path = _resume_plan(state, tmp_path, "metrics_stage1_*.csv",
                                       final_artifact=tmp_path / "unet_baseline.pth",
                                       patience=2)
    assert len(rows) == 3 and csv_path == csv_p
    for a, b in zip(out.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)  # the artifact was loaded into the model


def test_older_stage2_log_not_resumed(tmp_path):
    old_s2 = tmp_path / "metrics_stage2_old.csv"
    _write_csv(old_s2, [(1, 0.7), (2, 0.7)])
    stale = time.time() - 100
    os.utime(old_s2, (stale, stale))
    _, rows, csv_path = _resume_plan(_fresh(), tmp_path, "metrics_stage2_*.csv",
                                     num_epochs=2, min_mtime=time.time() - 10)
    assert rows is None and csv_path is None


# ------------------------------------------------------------- train() and CLI


def _splits():
    images, masks = make_blobs(8, 32, 32, seed=1)
    cut = lambda a, b: DeviceDataset.from_numpy(images[a:b], masks[a:b], "cpu")
    return dict(train_data=cut(0, 5), val_data=cut(5, 8))


def test_checkpoint_keep_bounds_retention(tmp_path):
    train(stage1_epochs=2, stage2_epochs=2, batch_size=4, base_channels=4, precision="f32",
          make_plots=False, verbose=False, device="cpu", output_dir=tmp_path / "output",
          models_dir=tmp_path / "models", checkpoint_every=1, checkpoint_keep=1, **_splits())
    for stage in ("stage1", "stage2"):
        names = [p.name for p in (tmp_path / "models" / "checkpoints" / stage).iterdir()]
        assert names == ["step_4"], (stage, names)


def _write_reference_layout(root):
    """images/{training,validation}/ + images/annotation/*_annotation.json"""
    ann_dir = root / "images" / "annotation"
    ann_dir.mkdir(parents=True)
    for i, split in enumerate(("training", "validation")):
        img_dir, ann = write_synthetic_coco(root / "tmp" / split, n=4, height=32, width=32,
                                            seed=i)
        shutil.move(str(img_dir), root / "images" / split)
        shutil.move(str(ann), ann_dir / f"{split}_annotation.json")


def _cli(root, *extra):
    cli_main(["--data-root", str(root), "--device", "cpu", "--base-channels", "4",
              "--batch-size", "4", "--precision", "f32", "--physics-backend", "torch",
              "--seed", "0", "--no-plots", "--checkpoint-every", "1", *extra])


def _stage_rows(root, stage):
    (path,) = (root / "output").glob(f"metrics_{stage}_*.csv")
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _crash_then_resume(tmp_path, monkeypatch, capsys, *epochs):
    """An uninterrupted CLI run, and a run crashed after Stage II epoch 1
    then resumed with ``--resume``; returns both roots and the resume's
    output."""
    roots = {}
    for name in ("whole", "crashed"):
        roots[name] = tmp_path / name
        _write_reference_layout(roots[name])
    _cli(roots["whole"], *epochs)
    monkeypatch.setenv("PIIS_FAULT_AFTER", "Stage II:1")
    with pytest.raises(RuntimeError, match="PIIS_FAULT_AFTER"):
        _cli(roots["crashed"], *epochs)
    models = roots["crashed"] / "models"
    assert (models / "unet_baseline.pth").exists()
    assert not (models / "unet_pde_regularized.pth").exists()
    monkeypatch.delenv("PIIS_FAULT_AFTER")
    capsys.readouterr()
    _cli(roots["crashed"], *epochs, "--resume")
    return roots, capsys.readouterr().out


def _assert_same_run(roots):
    for stage in ("stage1", "stage2"):
        assert _stage_rows(roots["crashed"], stage) == _stage_rows(roots["whole"], stage)
    for artifact in ("unet_baseline.pth", "unet_pde_regularized.pth"):
        a = load_params(roots["whole"] / "models" / artifact)
        b = load_params(roots["crashed"] / "models" / artifact)
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_cli_resume_after_injected_crash(tmp_path, monkeypatch, capsys):
    """Stage I is skipped through its final artifact, Stage II restarts from
    its checkpoint and continues its CSV in place; the finished run equals
    an uninterrupted one: CSV rows and final parameters, bit for bit."""
    roots, out = _crash_then_resume(tmp_path, monkeypatch, capsys,
                                    "--stage1-epochs", "2", "--stage2-epochs", "2")
    assert "[resume] stage already complete" in out and "[resume] restored" in out
    assert "TRAINING COMPLETE" in out
    assert [int(r["epoch"]) for r in _stage_rows(roots["crashed"], "stage2")] == [1, 2]
    _assert_same_run(roots)


def test_resume_after_an_early_stopped_stage1(tmp_path, monkeypatch, capsys):
    """Replaying Stage I's early stop rewrites its log; the interrupted
    Stage II log is still this run's and is continued, not discarded."""
    roots, out = _crash_then_resume(
        tmp_path, monkeypatch, capsys, "--stage1-epochs", "4", "--stage2-epochs", "2",
        "--learning-rate", "1e-12", "--early-stopping-patience", "1")
    assert len(_stage_rows(roots["crashed"], "stage1")) == 2  # stopped at epoch 2
    assert "[resume] restored" in out and "older than" not in out
    assert len(list((roots["crashed"] / "output").glob("metrics_stage2_*.csv"))) == 1
    _assert_same_run(roots)


def test_single_stage_resume(tmp_path, monkeypatch):
    kw = dict(use_two_stage=False, stage1_epochs=3, batch_size=4, base_channels=4,
              precision="f32", make_plots=False, verbose=False, device="cpu",
              checkpoint_every=2, **_splits())
    whole = train(output_dir=tmp_path / "a", models_dir=tmp_path / "a", **kw)
    monkeypatch.setenv("PIIS_FAULT_AFTER", "Training:3")
    with pytest.raises(RuntimeError, match="PIIS_FAULT_AFTER"):
        train(output_dir=tmp_path / "b", models_dir=tmp_path / "b", **kw)
    monkeypatch.delenv("PIIS_FAULT_AFTER")
    # the last checkpoint is the epoch-3 one; drop it so epoch 3 re-runs from epoch 2's
    (tmp_path / "b" / "checkpoints" / "single_stage" / "step_6").unlink()
    res = train(output_dir=tmp_path / "b", models_dir=tmp_path / "b", resume=True, **kw)
    assert res["single_stage"]["epochs"] == whole["single_stage"]["epochs"]
    assert [len(t["epoch_seconds"]) for t in res["stage_timings"]] == [1]
    for a, b in zip(res["model"].parameters(), whole["model"].parameters()):
        assert torch.equal(a, b)
    assert np.isfinite(res["single_stage"]["epochs"][-1]["train_loss"])
