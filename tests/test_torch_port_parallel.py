"""PyTorch port: data- and space-parallel training over gloo processes, held
against the port's single process and against the JAX package.

Inputs are made with numpy from fixed seeds; the U-Net is at base 4 and
computes in float32.  Multi-rank runs go through
``tests/torch_port_dist_worker.py`` (a ``file://`` store under the test's
temporary directory, every worker killed when one fails); the JAX side is
computed while they run.

* DP epochs on 2 processes (``make_sharded_epoch_fns``, a ragged final
  batch included) against the port's single-process epochs: losses and
  metrics rtol 1e-5, parameters atol 1e-5, at dropout 0 and at dropout 0.1
  (the ranks draw the global batch's masks and take their rows).  Against
  JAX ``make_sharded_epoch_fns`` on ``make_mesh(data=8)`` from the same
  weights (``utils/weights.py``), dropout 0, Stage I objective: the
  trajectory bar of tests/test_torch_port_train.py, rtol 2e-4.
* The data×space halo step on 4 processes (data 2 × space 2) against JAX
  ``make_sharded_train_step(spatial=True, halo_physics=True)`` on
  ``make_mesh(data=2, space=2)`` at 64×64, against the JAX single-device
  step and the port's single-process step at 32×32 and 64×64: loss rtol
  1e-5, parameters atol 1e-5 (tests/test_parallel.py).  At 32×32 the JAX
  data×space step's own weight gradients in the deepest layers are wrong
  (ROADMAP queue 3), so it is held at 64×64 there.
* ``shard_train_state`` for every optimizer; world-1 runs in this process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from physics_informed_image_segmentation_tpu import parallel as JP
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
from physics_informed_image_segmentation_tpu_torch.train import LossConfig, engine
from physics_informed_image_segmentation_tpu_torch.train.engine import _OPTIMIZERS
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax
from torch_port_dist_worker import Workers

C, HW = 4, 32
DP_PHYSICS = dict(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0)
STEP_PHYSICS = dict(pde_weight=1e-3, phase_field_weight=1e-4, diffusion_coeff=5.0)
LR = 1e-3
STEP_SIZES = (32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_model(seed):
    jmodel = JaxUNet(base_channels=C, dropout=0.0, dtype=jnp.float32)
    params = jmodel.init(jax.random.key(seed), jnp.zeros((1, HW, HW, 1), jnp.float32))
    weights = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), dropout=0.0)
    return jmodel, params, weights


def _port_model(dropout, weights=None, init_seed=5):
    model = UNet(base_channels=C, dropout=dropout,
                 generator=torch.Generator().manual_seed(init_seed))
    if weights is not None:
        model.load_state_dict(weights)
    return model


def _params(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


# --------------------------------------------------------------------------
# data-parallel epochs on 2 processes
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("dp")
    jmodel, jparams, weights = _jax_model(0)
    torch.save(weights, wd / "weights.pt")
    images, masks = make_blobs(12, HW, HW, seed=1)
    plans = [epoch_batch_indices(12, 8, shuffle=True, generator=torch.Generator().manual_seed(e))
             for e in range(2)]  # two batches an epoch, the second with 4 padded slots
    inp = dict(images=images, masks=masks, epochs=2, lr=LR, init_seed=5, world=2)
    for e, (idx, valid) in enumerate(plans):
        inp[f"idx{e}"], inp[f"valid{e}"] = idx.numpy(), valid.numpy()
    np.savez(wd / "inputs.npz", **inp)
    workers = Workers("dp", wd, 2)

    # JAX: the same epochs on 8 devices, dropout 0, Stage I objective
    jmesh = JP.make_mesh(data=8)
    jstate = jax_engine.create_train_state(jmodel, jax.random.key(0), LR,
                                           input_shape=(1, HW, HW, 1), params=jparams)
    jstate = JP.shard_train_state(jstate, jmesh)
    jtrain, _ = JP.make_sharded_epoch_fns(jmodel, JaxLossConfig(backend="jax"), jmesh)
    jrows = []
    for idx, valid in plans:
        jstate, jres = jtrain(jstate, jnp.asarray(images), jnp.asarray(masks),
                              jnp.asarray(idx.numpy()), jnp.asarray(valid.numpy()))
        jrows.append({k: float(v) for k, v in jres.items()})
    jweights = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), dropout=0.0)

    # the port in one process, at both dropout rates
    cfg = LossConfig(**DP_PHYSICS)
    single = {}
    x, y = torch.tensor(images), torch.tensor(masks)
    for tag, dropout in (("d0", 0.0), ("d1", 0.1)):
        model = _port_model(dropout, weights if dropout == 0.0 else None)
        state = engine.create_train_state(model, LR, dropout_seed=3)
        train_fn = engine.make_train_epoch_fn(cfg, precision="f32")
        rows = []
        for idx, valid in plans:
            state, res = train_fn(state, x, y, idx, valid)
            rows.append(res)
        val = engine.make_eval_epoch_fn(cfg, precision="f32")(model, x, y, *plans[0])
        single[tag] = dict(rows=rows, val=val, params=_params(model))
    return dict(outs=workers.results(), jrows=jrows, jweights=jweights, single=single)


@pytest.mark.parametrize("tag", ["d0", "d1"])
def test_dp_epochs_match_single_process(dp_run, tag):
    ref = dp_run["single"][tag]
    for rank, out in enumerate(dp_run["outs"]):
        for e, row in enumerate(ref["rows"]):
            for k, v in row.items():
                np.testing.assert_allclose(out[f"{tag}/train{e}/{k}"], v, rtol=1e-5, atol=1e-7,
                                           err_msg=f"rank {rank} epoch {e} {k}")
        for k, v in ref["val"].items():
            np.testing.assert_allclose(out[f"{tag}/val/{k}"], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {rank} val {k}")
        for k, v in ref["params"].items():
            np.testing.assert_allclose(out[f"{tag}/param/{k}"], v, rtol=0, atol=1e-5,
                                       err_msg=f"rank {rank} {k}")
    r0, r1 = dp_run["outs"]
    for k in ref["params"]:  # the replicas stay identical
        np.testing.assert_array_equal(r0[f"{tag}/param/{k}"], r1[f"{tag}/param/{k}"])


def test_dp_epochs_match_jax_sharded_epochs(dp_run):
    """Stage I objective: the JAX package's Stage II objective on 8 devices
    either takes its plain physics, which differentiates NHWC predictions
    over (W, C) (ROADMAP queue 3), or its Pallas kernel interpreted on the
    CPU, whose SPMD program can deadlock in XLA's CPU collectives."""
    out = dp_run["outs"][0]
    for e, jrow in enumerate(dp_run["jrows"]):
        for k, v in jrow.items():
            np.testing.assert_allclose(out[f"s1/train{e}/{k}"], v, rtol=2e-4, atol=1e-7,
                                       err_msg=f"epoch {e} {k}")
    for k, v in dp_run["jweights"].items():
        np.testing.assert_allclose(out[f"s1/param/{k}"], v.numpy(), rtol=2e-4, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_shard_train_state_makes_every_rank_rank_zeros(dp_run, name):
    r0, r1 = dp_run["outs"]
    assert int(r0[f"opt/{name}/count"]) == int(r1[f"opt/{name}/count"]) == 1
    np.testing.assert_array_equal(r1[f"opt/{name}/flat"], r0[f"opt/{name}/flat"])
    np.testing.assert_array_equal(r1[f"opt/{name}/draw"], r0[f"opt/{name}/draw"])


# --------------------------------------------------------------------------
# the data×space halo step on 4 processes
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """The 4-rank step at 32² and 64²; the JAX data×space step at 64², the
    JAX single-device step and the port's single process at both."""
    wd = tmp_path_factory.mktemp("step")
    _, _, weights = _jax_model(1)
    torch.save(weights, wd / "weights.pt")
    data = {h: make_blobs(8, h, h, seed=0) for h in STEP_SIZES}
    inp = dict(data=2, space=2, lr=LR, sizes=np.array(STEP_SIZES))
    for h, (images, masks) in data.items():
        inp[f"images{h}"], inp[f"masks{h}"] = images, masks
    np.savez(wd / "inputs.npz", **inp)
    workers = Workers("step", wd, 4)

    def jax_weights(state):
        return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params), dropout=0.0)

    ref = {}
    jmesh = JP.make_mesh(data=2, space=2)
    for h, (images, masks) in data.items():
        jmodel, jparams, _ = _jax_model(1)  # the sharded step donates its state
        jstate = jax_engine.create_train_state(jmodel, jax.random.key(0), LR,
                                               input_shape=(1, HW, HW, 1), params=jparams)
        jstate, jout = jax_engine.make_train_step_fn(
            jmodel, JaxLossConfig(backend="pallas", **STEP_PHYSICS))(
            jstate, jnp.asarray(images), jnp.asarray(masks), jnp.ones(8))
        ref[f"jax1/{h}"] = (float(jout["loss"]), jax_weights(jstate))
        if h != 32:
            jmodel, jparams, _ = _jax_model(1)
            jstate = JP.shard_train_state(jax_engine.create_train_state(
                jmodel, jax.random.key(0), LR, input_shape=(1, HW, HW, 1), params=jparams), jmesh)
            step = JP.make_sharded_train_step(jmodel, JaxLossConfig(backend="jax", **STEP_PHYSICS),
                                              jmesh, spatial=True, halo_physics=True)
            sh = JP.batch_space_sharding(jmesh)
            jstate, jloss = step(jstate, jax.device_put(jnp.asarray(images), sh),
                                 jax.device_put(jnp.asarray(masks), sh))
            ref[f"jax_sharded/{h}"] = (float(jloss), jax_weights(jstate))
        model = _port_model(0.0, weights)
        state = engine.create_train_state(model, LR)
        state, res = engine.make_train_step_fn(LossConfig(**STEP_PHYSICS), compute_metrics=False)(
            state, torch.tensor(images), torch.tensor(masks), torch.ones(8))
        ref[f"single/{h}"] = (float(res["loss"]), {k: torch.tensor(v) for k, v in
                                                    _params(model).items()})
    return dict(outs=workers.results(), ref=ref)


@pytest.mark.parametrize("ref", [
    "jax_sharded/64",  # JAX make_sharded_train_step(spatial=True, halo_physics=True), 2×2
    "jax1/32",         # at 32², where that step's gradients are wrong (ROADMAP queue 3),
    "jax1/64",         # and at 64²: the JAX single-device step
    "single/32", "single/64",  # the port's single process
])
def test_data_space_halo_step_matches(step_run, ref):
    h = ref.split("/")[1]
    loss, params = step_run["ref"][ref]
    for out in step_run["outs"]:
        np.testing.assert_allclose(out[f"halo{h}/loss"], loss, rtol=1e-5)
        for k, v in params.items():
            np.testing.assert_allclose(out[f"halo{h}/param/{k}"], v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_plain_halo_stencils_step_equals_halo_physics_step(step_run):
    """On the CPU both physics paths run K3's plain version."""
    for out in step_run["outs"]:
        assert out["plain/loss"] == out["halo32/loss"]
        for k in step_run["ref"]["single/32"][1]:
            np.testing.assert_array_equal(out[f"plain/param/{k}"], out[f"halo32/param/{k}"])


# --------------------------------------------------------------------------
# a world of one, in this process
# --------------------------------------------------------------------------


@pytest.fixture
def world1():
    P.initialize_distributed(device="cpu")
    try:
        yield P.make_mesh()
    finally:
        dist.destroy_process_group()


def test_mesh_at_world_one(world1):
    assert world1.shape == {"data": 1, "space": 1}
    assert (world1.data_rank, world1.space_rank) == (0, 0)
    assert world1.space_neighbours() == (None, None)
    P.initialize_distributed(device="cpu")  # a second call does nothing
    for kw in (dict(data=2), dict(space=2), dict(data=1, space=2)):
        with pytest.raises(ValueError):
            P.make_mesh(**kw)
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert torch.equal(P.batch_space_sharding(world1)(x), x)


def test_entry_points_run_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would succeed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.initialize_distributed()
    assert not dist.is_initialized()


def test_options_that_are_not_supported_raise(world1):
    cfg = LossConfig(**STEP_PHYSICS)
    with pytest.raises(ValueError, match="halo_physics requires spatial"):
        P.make_sharded_train_step(cfg, world1, spatial=False, halo_physics=True)
    state = engine.create_train_state(_port_model(0.0), LR)
    step = P.make_sharded_train_step(cfg, world1, spatial=True, halo_physics=True)
    images, masks = make_blobs(1, 40, 40, seed=0)
    with pytest.raises(ValueError, match="not divisible by 16"):
        step(state, torch.tensor(images), torch.tensor(masks))
    # space-sharded epochs: a band not divisible by 16, and a band shorter
    # than Boundary-F1's tolerance + 1 rows of halo
    train_fn, _ = P.make_sharded_epoch_fns(cfg, world1, spatial=True)
    idx, valid = torch.zeros((1, 1), dtype=torch.long), torch.ones((1, 1))
    with pytest.raises(ValueError, match="not divisible by 16"):
        train_fn(state, torch.tensor(images), torch.tensor(masks), idx, valid)
    band = torch.zeros((2, 1, 2, 8))
    with pytest.raises(ValueError, match="halo of 3 rows"):
        P.halo_exchange_pad(band, world1, "zero", rows=3)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_world_one_halo_step_matches_single_process_step(world1, dropout):
    """The check chip_smoke.py makes on the card, here on the CPU: the
    halo step's explicit conv halos and K3 path against the plain step."""
    cfg = LossConfig(**STEP_PHYSICS)
    images, masks = make_blobs(2, HW, HW, seed=3)
    x, y = torch.tensor(images), torch.tensor(masks)
    runs = {}
    for name in ("halo", "single"):
        model = _port_model(dropout)
        state = P.shard_train_state(engine.create_train_state(model, LR, dropout_seed=7), world1)
        if name == "halo":
            step = P.make_sharded_train_step(cfg, world1, spatial=True, halo_physics=True)
            state, loss = step(state, x, y)
        else:
            step = engine.make_train_step_fn(cfg, compute_metrics=False)
            state, out = step(state, x, y, torch.ones(2))
            loss = out["loss"]
        runs[name] = (float(loss), _params(model))
    (lh, ph), (ls, ps) = runs["halo"], runs["single"]
    np.testing.assert_allclose(lh, ls, rtol=1e-5)
    for k in ps:
        np.testing.assert_allclose(ph[k], ps[k], rtol=0, atol=1e-5, err_msg=k)


def test_world_one_sharded_stage_matches_plain_stage(world1):
    """``make_sharded_epoch_fns`` as a drop-in for ``train_stage``."""
    cfg = LossConfig(**DP_PHYSICS)
    images, masks = make_blobs(10, HW, HW, seed=4)
    train = DeviceDataset.from_numpy(images[:8], masks[:8], "cpu")
    val = DeviceDataset.from_numpy(images[8:], masks[8:], "cpu")
    rows = {}
    for name in ("sharded", "plain"):
        state = engine.create_train_state(_port_model(0.1), LR, dropout_seed=2)
        if name == "sharded":
            fns = P.make_sharded_epoch_fns(cfg, world1)
        else:
            fns = (engine.make_train_epoch_fn(cfg), engine.make_eval_epoch_fn(cfg))
        _, _, _, rows[name] = engine.train_stage(
            state, *fns, train, val, batch_size=3, num_epochs=2, stage_name="s",
            shuffle_seed=1, verbose=False)
    for a, b in zip(rows["sharded"], rows["plain"]):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=k)
