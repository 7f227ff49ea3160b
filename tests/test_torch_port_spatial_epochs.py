"""PyTorch port: space-sharded epochs (``make_sharded_epoch_fns(spatial=True)``)
held against the port's single process and against the JAX package.

* ``train_stage`` on 2 gloo processes (space 2) and on 4 (data 2 × space
  2) at 64×64, base 4, dropout 0, the Stage II objective with both physics
  weights, batch 4 with a ragged last batch, 2 epochs: against the port's
  single-process ``make_train_epoch_fn``/``make_eval_epoch_fn`` on the same
  weights and plans, loss columns rtol 1e-5, IoU and Boundary-F1 bit-equal,
  Dice rtol 1e-6, parameters atol 1e-5 (``test_data_space_halo_step_matches``).
  64×64, not 32×32: the JAX data×space step's gradients are wrong at 32² on
  4-device meshes (ROADMAP queue 3), and these runs follow the same bar.
* The world-1 spatial epoch in this process against JAX ``make_train_epoch_fn``
  with the Pallas physics backend (interpreted) at 64², one batch with a
  padded slot: loss rtol 2e-5, parameters after the step rtol 2e-4 (the bars
  of tests/test_torch_port_train.py).
* ``parallel/launch.py`` joins 2 gloo ranks of ``parallel/megapixel.py``;
  ``parallel/spatial_check.py`` passes its bars at world 1.
* Boundary-F1 of a mask whose boundary lies within 2 rows of a band edge:
  the bands' counts with a halo of tolerance + 1 rows add up to the
  unsharded value bit for bit, and without the halo they do not.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from physics_informed_image_segmentation_tpu.models import UNet as JaxUNet
from physics_informed_image_segmentation_tpu.train import engine as jax_engine
from physics_informed_image_segmentation_tpu.train.objective import LossConfig as JaxLossConfig
from physics_informed_image_segmentation_tpu_torch import parallel as P
from physics_informed_image_segmentation_tpu_torch.data import (
    DeviceDataset,
    epoch_batch_indices,
    make_blobs,
)
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.ops import metrics as M
from physics_informed_image_segmentation_tpu_torch.train import LossConfig, engine
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_dist_worker import Workers

REPO = Path(__file__).resolve().parent.parent
C, HW, BATCH, EPOCHS, LR, SEED = 4, 64, 4, 2, 1e-3, 5
PHYSICS = dict(pde_weight=1e-3, phase_field_weight=1e-4, diffusion_coeff=5.0)
LOSS_COLUMNS = ("loss", "dice_loss", "bce_loss", "pde_loss", "phase_field_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_weights(seed=0):
    jmodel = JaxUNet(base_channels=C, dropout=0.0, dtype=jnp.float32)
    params = jmodel.init(jax.random.key(seed), jnp.zeros((1, HW, HW, 1), jnp.float32))
    weights = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), dropout=0.0)
    return jmodel, params, weights


def _model(weights):
    model = UNet(base_channels=C, dropout=0.0)
    model.load_state_dict(weights)
    return model


def _params(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _stage(weights, train, val, fns_of):
    model = _model(weights)
    state = engine.create_train_state(model, LR)
    state, _, _, rows = engine.train_stage(
        state, *fns_of(), train, val, batch_size=BATCH, num_epochs=EPOCHS,
        stage_name="spatial", shuffle_seed=SEED, verbose=False)
    return model, rows


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """The 2- and 4-rank runs (started at once) and the single process."""
    images, masks = make_blobs(9, HW, HW, seed=11)
    _, _, weights = _jax_weights()
    val_idx, val_valid = epoch_batch_indices(3, BATCH, shuffle=False)
    inputs = dict(train_images=images[:6], train_masks=masks[:6], val_images=images[6:],
                  val_masks=masks[6:], val_idx=val_idx.numpy(), val_valid=val_valid.numpy(),
                  base=C, lr=LR, batch=BATCH, epochs=EPOCHS, seed=SEED)
    workers = {}
    for world, (data, space) in {2: (1, 2), 4: (2, 2)}.items():
        workdir = tmp_path_factory.mktemp(f"spatial{world}")
        torch.save(weights, workdir / "weights.pt")
        np.savez(workdir / "inputs.npz", data=data, space=space, **inputs)
        workers[world] = Workers("spatial", workdir, world)

    train = DeviceDataset.from_numpy(images[:6], masks[:6], "cpu")
    val = DeviceDataset.from_numpy(images[6:], masks[6:], "cpu")
    cfg = LossConfig(**PHYSICS)
    model, rows = _stage(weights, train, val,
                         lambda: (engine.make_train_epoch_fn(cfg), engine.make_eval_epoch_fn(cfg)))
    ref = {f"row{e}/{k}": v for e, row in enumerate(rows) for k, v in row.items()}
    res = engine.make_eval_epoch_fn(cfg)(model, val.images, val.masks, val_idx, val_valid)
    ref.update({f"val/{k}": v for k, v in res.items()})
    ref.update(_params(model))
    return ref, {world: w.results() for world, w in workers.items()}


def _column_bar(key):
    column = key.split("/")[-1]
    if any(column.endswith(c) for c in LOSS_COLUMNS):
        return dict(rtol=1e-5, atol=0)
    if "iou" in column or "boundary_f1" in column:
        return dict(rtol=0, atol=0)
    if "dice" in column:
        return dict(rtol=1e-6, atol=0)
    raise AssertionError(f"no bar for {key}")


@pytest.mark.parametrize("world", [2, 4])
def test_spatial_epochs_match_single_process(spatial_runs, world):
    ref, runs = spatial_runs
    metric_keys = [k for k in ref if k.startswith(("row", "val/")) and not k.endswith("/epoch")]
    assert any("boundary_f1" in k for k in metric_keys)
    for rank, out in enumerate(runs[world]):
        for k in metric_keys:
            np.testing.assert_allclose(out[k], ref[k], err_msg=f"rank {rank} {k}",
                                       **_column_bar(k))
        for k in ref:
            if "/" not in k or k.startswith(("row", "val/")):
                continue
            np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-5,
                                       err_msg=f"rank {rank} {k}")


def test_spatial_epochs_agree_on_every_rank(spatial_runs):
    _, runs = spatial_runs
    for world, outs in runs.items():
        for out in outs[1:]:
            for k in outs[0]:
                if k.startswith(("row", "val/")):
                    assert out[k] == outs[0][k], (world, k)


def test_launcher_joins_ranks_on_a_file_store():
    """``parallel/launch.py`` starts 2 gloo ranks of ``parallel/megapixel.py``
    (a 32x32 image, base 2) joined through a file store: both print the same
    losses of a world of 2."""
    pkg = "physics_informed_image_segmentation_tpu_torch.parallel"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    done = subprocess.run(
        [sys.executable, "-m", f"{pkg}.launch", "2", f"{pkg}.megapixel", "32", "2",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout[-4000:]
    lines = [json.loads(line.split("] ", 1)[1]) for line in done.stdout.splitlines()
             if "] {" in line]
    assert sorted(r["rank"] for r in lines) == [0, 1]
    assert all(r["world"] == 2 and r["mesh"] == {"data": 1, "space": 2} for r in lines)
    assert lines[0]["losses"] == lines[1]["losses"]


# --------------------------------------------------------------------------
# a world of one, in this process, against JAX
# --------------------------------------------------------------------------


@pytest.fixture
def world1():
    P.initialize_distributed(device="cpu")
    try:
        yield P.make_mesh()
    finally:
        dist.destroy_process_group()


def test_world_one_spatial_epoch_matches_jax_pallas(world1):
    jmodel, jparams, weights = _jax_weights(seed=3)
    images, masks = make_blobs(3, HW, HW, seed=12)
    idx, valid = epoch_batch_indices(3, BATCH, shuffle=False)
    assert float(valid.sum()) < BATCH  # a padded slot

    jstate = jax_engine.create_train_state(jmodel, jax.random.key(0), LR, params=jparams)
    jfn = jax_engine.make_train_epoch_fn(
        jmodel, JaxLossConfig(backend="pallas", **PHYSICS))
    jstate, jres = jfn(jstate, jnp.asarray(images), jnp.asarray(masks),
                       jnp.asarray(idx.numpy()), jnp.asarray(valid.numpy()))

    model = _model(weights)
    state = P.shard_train_state(engine.create_train_state(model, LR), world1)
    train_fn, _ = P.make_sharded_epoch_fns(LossConfig(**PHYSICS), world1, spatial=True)
    _, res = train_fn(state, torch.tensor(images), torch.tensor(masks), idx, valid)

    for k in (*LOSS_COLUMNS, "dice_score", "iou_score", "boundary_f1_score"):
        np.testing.assert_allclose(res[k], float(jres[k]), rtol=2e-5, err_msg=k)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), dropout=0.0)
    for k, v in _params(model).items():
        np.testing.assert_allclose(v, ref[k].numpy(), rtol=2e-4, atol=1e-7, err_msg=k)


def test_spatial_check_at_world_one(world1):
    """``parallel/spatial_check.py`` in this process: the stage and the first
    batch's gradient against the unsharded ones, within its bars."""
    from physics_informed_image_segmentation_tpu_torch.parallel import spatial_check

    res = spatial_check.run()
    assert res["ok"] and res["grad_ok"], res
    assert res["first_step_grad_max_rel_l2"] <= spatial_check.GRAD_REL


@pytest.mark.parametrize("bands", [1, 2, 4])
def test_banded_forward_is_the_sharded_forward(world1, bands):
    """``grad_arbiter.banded_forward_nhwc`` runs the space-sharded forward's
    shapes in one process: equal to the whole forward, and at one band bit
    for bit the world-one band path."""
    from physics_informed_image_segmentation_tpu_torch.parallel import grad_arbiter
    from physics_informed_image_segmentation_tpu_torch.parallel.sharding import MeshShard

    model = UNet(base_channels=4, dropout=0.0, generator=torch.Generator().manual_seed(0))
    x = torch.tensor(make_blobs(2, 64, 48, seed=4)[0])
    banded = grad_arbiter.banded_forward_nhwc(model, x, bands)
    torch.testing.assert_close(banded, engine.forward_nhwc(model, x, "f32"), rtol=0, atol=1e-6)
    if bands == 1:
        assert torch.equal(banded, MeshShard(world1, spatial=True).forward(model, x, "f32"))


def test_trajectory_gap_is_the_unsharded_runs_own_rounding(world1):
    """Why ``spatial_check``'s parameter bar reads the same size whether the
    run is sharded or not: the unsharded stage against itself with only its
    convolutions' algorithms changed (oneDNN off here; cuDNN off on the
    card) differs as much as the sharded stage does.  Observed here: both
    one float32 ulp of the largest parameter, 7.4e-5 of the movement; on
    an H100 at base 64, 128²: 26.8%, where the sharded runs read 29% (data 2
    × space 2) and 7.5% (world 1).  And the first step's gradient: every
    float32 path within 1e-5 of the float64 gradient at this size."""
    from physics_informed_image_segmentation_tpu_torch.parallel import grad_arbiter, spatial_check

    res = spatial_check.run()
    own = grad_arbiter.self_gap(64, 4, device="cpu")["plain"]
    assert 0 < own["ratio"] <= spatial_check.PARAM_REL
    assert res["max_abs_dparam"] / res["movement"] <= 2 * own["ratio"]
    arbiter = grad_arbiter.first_step_arbiter(64, 4, device="cpu")
    paths = {k: v for k, v in arbiter.items() if k != "vs_whole"}
    assert len(paths) == 6 and all(v["max_rel_l2"] <= 1e-5 for v in paths.values()), paths


# --------------------------------------------------------------------------
# Boundary-F1 across a band edge
# --------------------------------------------------------------------------


def _band_counts(pred_bin, target, n_bands, halo):
    """Sum of the bands' Boundary-F1 counts, each band with ``halo`` rows
    of its neighbours (zero rows beyond the image) as the exchange gives."""
    h = pred_bin.shape[1] // n_bands
    both = torch.nn.functional.pad(torch.stack([pred_bin, target]), (0, 0, halo, halo))
    total = 0
    for b in range(n_bands):
        band = both[:, :, b * h:(b + 1) * h + 2 * halo]
        total = total + M.boundary_counts(band[0], band[1], halo=halo)
    return total


def test_boundary_f1_across_a_band_edge():
    h = w = 32
    yy, xx = np.mgrid[:h, :w]
    # the target's lower edge lies on row 17, two rows past the band edge
    # at 16; the prediction's on row 14, two rows before it
    target = ((yy >= 4) & (yy <= 17) & (xx >= 5) & (xx <= 25)).astype(np.float32)
    pred = ((yy >= 4) & (yy <= 14) & (xx >= 6) & (xx <= 25)).astype(np.float32) * 0.9
    p, t = torch.tensor(pred)[None], torch.tensor(target)[None]
    p = torch.cat([p, p.flip(1)])
    t = torch.cat([t, t.flip(1)])
    unsharded = M.boundary_f1_per_sample(p, t)
    pred_bin = (p > M.THRESHOLD).to(p.dtype)
    k = M.BOUNDARY_TOLERANCE + 1
    for n_bands in (2, 4):
        banded = M.boundary_f1_from_counts(_band_counts(pred_bin, t, n_bands, k))
        assert torch.equal(banded, unsharded), (n_bands, banded, unsharded)
        cut = M.boundary_f1_from_counts(_band_counts(pred_bin, t, n_bands, 0))
        assert not torch.equal(cut, unsharded)
