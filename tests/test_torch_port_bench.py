"""PyTorch port: the measurement entry points (``bench`` and ``scripts/``),
on the CPU at small sizes.

* ``analytic_flops_per_step`` equals the root ``bench.py``'s, loaded from
  its file (it imports no JAX at module level), at the defaults and at
  small shapes.
* ``bench.main`` prints one parseable line with its keys; ``mfu`` is null
  on the CPU.
* The bench's workload on JAX weights (``state_dict_from_jax``) with the
  same stacked plans gives the JAX ``make_train_epochs_fn``'s per-epoch
  losses and metrics: one step an epoch, so epoch 0 is the first step on
  the same weights (loss rtol 2e-5) and the later epochs follow updates
  (rtol 2e-4), the bars of tests/test_reference_parity.py.  The JAX side
  runs its Pallas physics interpreted, as its own tests do.
* ``floor_bench``'s ``full`` rung is ``make_train_step_fn``'s step bit for
  bit, and its ``loss`` rung's parameter gradient is JAX's gradient of
  ``make_loss_and_components`` on the same weights and batch within the
  bar of tests/test_torch_port_unet.py (rtol 1e-4 + atol 1e-6·max|g|),
  the port's gradient pass on PyTorch's own CPU convolutions as there.
* ``serve_bench``'s two-size split on known times.
* Every script prints parseable lines at tiny sizes with ``--device cpu``;
  ``sweep_bench``'s batched members against its serial runs within the
  sweep tests' bar (rtol 2e-4 / atol 1e-7).
"""

import contextlib
import copy
import importlib.util
import io
import json
import os
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.models import UNet as JaxUNet
from physics_informed_image_segmentation_tpu.train import engine as jax_engine
from physics_informed_image_segmentation_tpu.train.objective import LossConfig as JaxLossConfig
from physics_informed_image_segmentation_tpu_torch import bench
from physics_informed_image_segmentation_tpu_torch.scripts import (
    ab_bench,
    data_bench,
    floor_bench,
    megapixel_bench,
    member_bench,
    serve_bench,
    sweep_bench,
)
from physics_informed_image_segmentation_tpu_torch.train import LossConfig, make_train_step_fn
from physics_informed_image_segmentation_tpu_torch.train.objective import make_loss_and_components
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--base-channels", "4", "--size", "32", "--precision", "f32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lines(main, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):  # it sets JAX cache variables
        spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape", [None, (2, 32, 4), (1, 64, 8), (4, 16, 2)])
def test_flops_equal_the_root_bench(root_bench, shape):
    if shape is None:
        assert bench.analytic_flops_per_step() == root_bench.analytic_flops_per_step()
        assert bench.analytic_flops_per_step() == 544_890_421_248
    else:
        assert bench.analytic_flops_per_step(*shape) == root_bench.analytic_flops_per_step(*shape)


def test_bench_prints_one_line_with_its_keys():
    (line,) = _lines(bench.main, [*TINY, "--dropout", "0", "--images", "16", "--epochs", "2",
                                  "--warmup", "1", "--rounds", "2"])
    keys = {"metric", "value", "unit", "rounds", "min", "max", "step_time_ms",
            "flops_per_step", "device_kind", "peak_flops_assumed", "mfu", "physics_backend",
            "optimizer", "kernel_check", "launches_per_step", "card"}
    assert keys <= set(line)
    assert line["metric"] == "train_images_per_sec_per_chip"
    assert line["unit"] == "images/sec/chip"
    assert len(line["rounds"]) == 2 and line["min"] <= line["value"] <= line["max"]
    assert line["mfu"] is None and line["peak_flops_assumed"] is None
    assert line["device_kind"] == "cpu" and line["physics_backend"] == "torch"
    assert line["flops_per_step"] == bench.analytic_flops_per_step(8, 32, 4)
    assert np.isfinite(line["final_loss"])


def test_bench_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_bench()


def _jax_model_and_params(base, hw):
    model = JaxUNet(base_channels=base, dropout=0.0, dtype=jnp.float32)
    params = model.init(jax.random.key(0), jnp.zeros((1, hw, hw, 1), jnp.float32))
    return model, params


def test_bench_workload_matches_jax_epochs():
    base, hw, epochs = 4, 32, 3
    jmodel, params = _jax_model_and_params(base, hw)
    wl = bench.make_workload("cpu", n_images=8, size=hw, base_channels=base, epochs=epochs,
                             precision="f32", dropout=0.0)
    wl.state.model.load_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), dropout=0.0))
    res = wl.call()

    jstate = jax_engine.create_train_state(jmodel, jax.random.key(1), bench.LEARNING_RATE,
                                           input_shape=(1, hw, hw, 1), params=params)
    fn = jax_engine.make_train_epochs_fn(
        jmodel, JaxLossConfig(backend="pallas", **bench.STAGE2), compute_metrics=True)
    as_jax = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    _, ref = fn(jstate, as_jax(wl.data.images), as_jax(wl.data.masks), as_jax(wl.idx),
                as_jax(wl.valid))
    assert set(res) == set(ref)
    for k in res:
        ours, theirs = res[k], np.asarray(ref[k])
        np.testing.assert_allclose(ours[0], theirs[0], rtol=2e-5, err_msg=f"epoch 0 {k}")
        np.testing.assert_allclose(ours[1:], theirs[1:], rtol=2e-4, atol=1e-7, err_msg=k)


def test_floor_full_rung_is_the_train_step():
    wl = bench.make_workload("cpu", n_images=8, size=32, base_channels=4, epochs=1,
                             precision="f32")
    cfg = LossConfig(**bench.STAGE2)
    a, b = wl.state, copy.deepcopy(wl.state)
    rung = floor_bench.make_rung("full", cfg, "f32")
    step = make_train_step_fn(cfg, precision="f32")
    x, y, v = wl.data.images, wl.data.masks, torch.ones(8)
    for _ in range(2):
        la = rung(a, x, y, v)
        b, out = step(b, x, y, v)
        assert torch.equal(la, out["loss"])
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(a.dropout_generator.get_state(), b.dropout_generator.get_state())


def test_floor_loss_rung_gradient_matches_jax():
    base, hw = 4, 32
    jmodel, params = _jax_model_and_params(base, hw)
    wl = bench.make_workload("cpu", n_images=4, size=hw, base_channels=base, epochs=1,
                             precision="f32", dropout=0.0)
    wl.state.model.load_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), dropout=0.0))
    x, y = wl.data.images, wl.data.masks
    valid = torch.tensor([1.0, 1.0, 1.0, 0.0])
    with torch.backends.mkldnn.flags(enabled=False):
        total, grads = floor_bench.loss_and_grads(
            wl.state, make_loss_and_components(LossConfig(**bench.STAGE2)), x, y, valid, "f32")

    jloss = jax_engine.make_loss_and_components(JaxLossConfig(backend="pallas", **bench.STAGE2))
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    jmask = jnp.asarray(valid.numpy()).reshape(4, 1, 1, 1)
    jtotal, jgrads = jax.value_and_grad(
        lambda p: jloss(jmodel.apply(p, jx, deterministic=True), jy, jmask)[0])(params)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=2e-5)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), dropout=0.0)
    names = [n for n, _ in wl.state.model.named_parameters()]
    for name, g in zip(names, grads):
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(r).max()) + 1e-12, err_msg=name)


def test_serve_split_on_known_times():
    per, fixed = 1e-4, 0.05
    got_per, got_fixed = serve_bench.split_rate(128, fixed + 128 * per, 1024, fixed + 1024 * per)
    assert got_per == pytest.approx(per, rel=1e-12)
    assert got_fixed == pytest.approx(fixed, rel=1e-12)
    with pytest.raises(ValueError):
        serve_bench.split_rate(128, 0.1, 128, 0.2)


def test_ab_bench_lines():
    lines = _lines(ab_bench.main, ["adamw", "opt=flat_adamw,flat=1", "bs=4", "calls=epoch",
                                   *TINY, "--images", "8", "--epochs", "1", "--warmup", "0",
                                   "--rounds", "2"])
    assert [ln["variant"] for ln in lines[:-1]] == ["adamw", "opt=flat_adamw,flat=1", "bs=4",
                                                    "calls=epoch"]
    assert [ln["batch_size"] for ln in lines[:-1]] == [8, 8, 4, 8]
    assert lines[-1]["rounds"] == 2 and len(lines[-1]["ab_ratios"]) == 3
    for ratio in lines[-1]["ab_ratios"].values():
        assert len(ratio["turns"]) == 2 and ratio["min"] <= ratio["median"] <= ratio["max"]
    with pytest.raises(ValueError, match="unknown variant setting"):
        ab_bench.parse_variant("pool=xla")


def test_floor_and_megapixel_and_serve_lines():
    lines = _lines(floor_bench.main, [*TINY, "--steps", "2", "--warmup", "0", "--timed", "1"])
    assert [ln["rung"] for ln in lines[:-1]] == list(floor_bench.RUNGS)
    assert list(lines[-1]["delta_ms"]) == list(floor_bench.RUNGS)
    on, off = _lines(megapixel_bench.main, ["48", "1", "--device", "cpu", "--base-channels", "4",
                                            "--precision", "f32"])
    assert (on["remat"], off["remat"]) == (True, False)
    assert on["losses"] == off["losses"] and len(on["losses"]) == 2
    lines = _lines(serve_bench.main, ["--device", "cpu", "--images", "8", "--batch-size", "2",
                                      "--base-channels", "4", "--size", "32", "--precision",
                                      "f32"])
    assert [ln["mode"] for ln in lines] == ["plain", "tta"]


def test_sweep_and_member_and_data_lines():
    batched, serial, results = _lines(sweep_bench.main, [
        *TINY, "--members", "2", "--epochs", "1", "--train", "8", "--val", "8"])
    assert (batched["mode"], serial["mode"], batched["members"]) == ("batched", "serial", 2)
    res = results["members_results"]
    np.testing.assert_allclose(res["batched"]["best_val_dice"], res["serial"]["best_val_dice"],
                               rtol=2e-4, atol=1e-7)
    assert res["batched"]["stop_epoch"] == res["serial"]["stop_epoch"]
    lines = _lines(member_bench.main, ["1", "2", *TINY, "--epochs-lo", "1", "--epochs-hi", "2",
                                       "--repeats", "1", "--train", "8", "--val", "8"])
    assert [ln["members"] for ln in lines] == [1, 2]
    lines = _lines(data_bench.main, ["--device", "cpu", "--images", "8", "--epochs", "1"])
    assert [ln["stage"] for ln in lines] == ["decode", "decode", "stream"]
    assert lines[-1]["images"] == 8


def test_port_imports_neither_the_root_bench_nor_the_root_scripts():
    """The port keeps its own copies: no absolute import of the root
    ``bench`` module or of ``scripts`` (its own are imported relatively)."""
    import ast

    port = REPO / "physics_informed_image_segmentation_tpu_torch"
    bad = []
    for path in sorted(port.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            bad += [f"{path.name}: {n}" for n in names
                    if n and n.split(".")[0] in ("bench", "scripts")]
    assert not bad, bad
