"""PyTorch port: optimizer, one train step and the two-stage slice, held
against the JAX package on the same weights and batches.

Both sides run in float32 with dropout 0 (the two frameworks cannot draw
the same dropout masks).  The JAX side uses the Pallas physics backend
(interpreted on the CPU): its plain backend runs the stencils over
(W, C) on (B, H, W, 1) predictions, see test_torch_port_kernel.py.
Tolerances are those of tests/test_reference_parity.py: loss rtol 2e-5,
post-step loss and parameters rtol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from physics_informed_image_segmentation_tpu.data import DeviceDataset as JaxDataset
from physics_informed_image_segmentation_tpu.models import UNet as JaxUNet
from physics_informed_image_segmentation_tpu.train import engine as jax_engine
from physics_informed_image_segmentation_tpu.train import loop as jax_loop
from physics_informed_image_segmentation_tpu.train.objective import LossConfig as JaxLossConfig
from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs
from physics_informed_image_segmentation_tpu_torch.models import MODELS, UNet
from physics_informed_image_segmentation_tpu_torch.train import engine
from physics_informed_image_segmentation_tpu_torch.train import loop
from physics_informed_image_segmentation_tpu_torch.train.objective import (
    LossConfig,
    make_loss_and_components,
)
from physics_informed_image_segmentation_tpu_torch.train.optim import AdamW
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax

C, HW = 8, 32
PHYSICS = dict(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=5.0,
               reaction_threshold=0.5, epsilon=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _models(seed=0):
    jmodel = JaxUNet(base_channels=C, dropout=0.0, dtype=jnp.float32)
    params = jmodel.init(jax.random.key(seed), jnp.zeros((1, HW, HW, 1), jnp.float32))
    model = UNet(base_channels=C, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                              dropout=0.0))
    return jmodel, params, model


def _assert_params_close(model, jax_params, rtol):
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), dropout=0.0)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=rtol,
                                   atol=1e-7, err_msg=name)


def test_adamw_follows_optax():
    """rtol 1e-6, not bit-equality: optax run op by op here computes
    b2**count by another route than the float32 power of optax under jit
    (and of the port), e.g. 0.00299692 against 0.0029969811 at count 3;
    and under jit XLA's CPU compiler contracts the moment updates into
    fused multiply-adds, which the port rounds in two steps.  The port
    divides by the bias corrections truly, as optax does, on the CPU and
    on the card (``optim._true_div``)."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = optax.adamw(learning_rate=1e-3, weight_decay=1e-5)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = AdamW(tp, 1e-3, 1e-5)
    for step in range(4):
        grads = [rng.normal(size=s).astype(np.float32) * 10.0 ** -step for s in shapes]
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.tensor(g) for g in grads])
    assert opt.count == 4
    for ours, ref in zip(tp, jp):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)


def test_one_train_step_matches_jax():
    """Stage II objective, f32, dropout 0, a batch with one padded slot."""
    lr = 1e-3
    jmodel, params, model = _models()
    images, masks = make_blobs(4, HW, HW, seed=0)
    valid = np.array([1, 1, 1, 0], np.float32)

    jcfg = JaxLossConfig(backend="pallas", **PHYSICS)
    jstate = jax_engine.create_train_state(jmodel, jax.random.key(1), lr,
                                           input_shape=(1, HW, HW, 1), params=params)
    jstate, jout = jax_engine.make_train_step_fn(jmodel, jcfg)(
        jstate, jnp.asarray(images), jnp.asarray(masks), jnp.asarray(valid))
    jloss_fn = jax_engine.make_loss_and_components(jcfg)
    jmask = jnp.asarray(valid).reshape(4, 1, 1, 1)
    jpost = jloss_fn(jmodel.apply(jstate.params, jnp.asarray(images)), jnp.asarray(masks), jmask)[0]

    cfg = LossConfig(**PHYSICS)
    state = engine.create_train_state(model, lr)
    x, y, v = torch.tensor(images), torch.tensor(masks), torch.tensor(valid)
    state, out = engine.make_train_step_fn(cfg, precision="f32")(state, x, y, v)
    with torch.no_grad():
        post = make_loss_and_components(cfg)(
            engine.forward_nhwc(model.eval(), x, "f32"), y, v.reshape(4, 1, 1, 1))[0]

    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=2e-5)
    for k in ("dice_loss", "bce_loss", "pde_loss", "phase_field_loss"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=2e-5, err_msg=k)
    for k in ("dice_sum", "iou_sum", "bf1_sum", "n"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(post), float(jpost), rtol=2e-4)
    _assert_params_close(model, jstate.params, rtol=2e-4)
    assert state.step == int(jstate.step) == 1


def _jax_stage(jmodel, state, cfg, train, val, epochs, key, batch):
    return jax_engine.train_stage(
        state, jax_engine.make_train_epoch_fn(jmodel, cfg),
        jax_engine.make_eval_epoch_fn(jmodel, cfg), train, val,
        batch_size=batch, num_epochs=epochs, stage_name="s", shuffle_key=key,
        early_stopping=jax_engine.EarlyStopping(1, 1e-4, "max"), verbose=False)


def _port_stage(state, cfg, train, val, epochs, batch):
    return engine.train_stage(
        state, engine.make_train_epoch_fn(cfg), engine.make_eval_epoch_fn(cfg), train, val,
        batch_size=batch, num_epochs=epochs, stage_name="s",
        shuffle_seed=0,
        early_stopping=engine.EarlyStopping(1, 1e-4, "max"), verbose=False)


def _assert_rows_close(rows, jrows):
    assert len(rows) == len(jrows)  # same early-stop epoch
    for row, jrow in zip(rows, jrows):
        assert row.keys() == jrow.keys()
        for k in row:
            np.testing.assert_allclose(row[k], jrow[k], rtol=2e-4, atol=1e-7,
                                       err_msg=f"epoch {row['epoch']} {k}")


def test_two_stage_slice_matches_jax():
    """Stage I then Stage II (fresh AdamW at 0.1x lr) with batch_size > n, so
    each epoch is one batch and the shuffle order cannot matter."""
    lr, batch, n_train = 1e-3, 6, 4
    jmodel, params, model = _models(seed=2)
    images, masks = make_blobs(n_train + 2, HW, HW, seed=3)
    jtrain = JaxDataset.from_numpy(images[:n_train], masks[:n_train])
    jval = JaxDataset.from_numpy(images[n_train:], masks[n_train:])
    train = DeviceDataset.from_numpy(images[:n_train], masks[:n_train], "cpu")
    val = DeviceDataset.from_numpy(images[n_train:], masks[n_train:], "cpu")
    cfg1, jcfg1 = LossConfig(), JaxLossConfig(backend="pallas")
    cfg2, jcfg2 = LossConfig(**PHYSICS), JaxLossConfig(backend="pallas", **PHYSICS)
    key = jax.random.key(5)

    jstate = jax_engine.create_train_state(jmodel, key, lr, input_shape=(1, HW, HW, 1),
                                           params=params)
    jstate, _, _, jrows1 = _jax_stage(jmodel, jstate, jcfg1, jtrain, jval, 3, key, batch)
    jstate = jax_engine.create_train_state(jmodel, key, lr * 0.1, input_shape=(1, HW, HW, 1),
                                           params=jstate.params)
    jstate, _, _, jrows2 = _jax_stage(jmodel, jstate, jcfg2, jtrain, jval, 3, key, batch)

    state, _, _, rows1 = _port_stage(engine.create_train_state(model, lr), cfg1, train, val, 3,
                                     batch)
    state, _, _, rows2 = _port_stage(engine.create_train_state(model, lr * 0.1), cfg2, train,
                                     val, 3, batch)

    _assert_rows_close(rows1, jrows1)
    _assert_rows_close(rows2, jrows2)
    assert all(r["train_pde_loss"] > 0 for r in rows2)
    _assert_params_close(model, jstate.params, rtol=2e-4)


def test_early_stopping_matches_jax():
    scores = [0.1, 0.1, 0.3, 0.30005, 0.2, 0.25, 0.1]
    ours, ref = engine.EarlyStopping(2), jax_engine.EarlyStopping(2)
    assert [ours(s, i) for i, s in enumerate(scores)] == [ref(s, i) for i, s in enumerate(scores)]
    assert (ours.best_epoch, ours.best_score) == (ref.best_epoch, ref.best_score)


def test_train_with_checkpoints_matches_jax_train(tmp_path, monkeypatch):
    """Both packages' ``train()`` with ``checkpoint_every=1`` from the same
    weights (the JAX train()'s own init, transplanted), f32, dropout 0,
    batch_size > n: per-epoch rows and final params within the slice
    tolerance (rtol 2e-4), and the port's checkpoints written."""
    lr, seed, n_train = 1e-3, 4, 4
    # the params JAX train() draws: root key -> init key -> params key
    init_key, _ = jax.random.split(jax.random.key(seed))
    params_key, _ = jax.random.split(init_key)
    jmodel = JaxUNet(base_channels=C, dropout=0.0, dtype=jnp.float32)
    params = jmodel.init(params_key, jnp.zeros((1, HW, HW, 1), jnp.float32))
    weights = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), dropout=0.0)

    def port_unet(generator=None, **kw):
        model = UNet(dropout=0.0, **kw)
        model.load_state_dict(weights)
        return model

    monkeypatch.setattr(jax_loop, "UNet", lambda **kw: JaxUNet(**{**kw, "dropout": 0.0}))
    monkeypatch.setitem(MODELS, "unet", port_unet)
    images, masks = make_blobs(n_train + 2, HW, HW, seed=6)
    common = dict(stage1_epochs=3, stage2_epochs=2, batch_size=6, learning_rate=lr, seed=seed,
                  base_channels=C, precision="f32", make_plots=False, verbose=False,
                  checkpoint_every=1, **PHYSICS)
    jres = jax_loop.train(
        train_data=JaxDataset.from_numpy(images[:n_train], masks[:n_train]),
        val_data=JaxDataset.from_numpy(images[n_train:], masks[n_train:]),
        physics_backend="pallas", output_dir=tmp_path / "jax", models_dir=tmp_path / "jax",
        **common)
    res = loop.train(
        train_data=DeviceDataset.from_numpy(images[:n_train], masks[:n_train], "cpu"),
        val_data=DeviceDataset.from_numpy(images[n_train:], masks[n_train:], "cpu"),
        device="cpu", output_dir=tmp_path / "port", models_dir=tmp_path / "port", **common)

    _assert_rows_close(res["stage1"]["epochs"], jres["stage1"]["epochs"])
    _assert_rows_close(res["stage2"]["epochs"], jres["stage2"]["epochs"])
    _assert_params_close(res["model"], jres["final_state"].params, rtol=2e-4)
    for stage, steps in (("stage1", ["step_2", "step_3"]), ("stage2", ["step_1", "step_2"])):
        names = sorted(p.name for p in (tmp_path / "port" / "checkpoints" / stage).iterdir())
        assert names == steps, (stage, names)
