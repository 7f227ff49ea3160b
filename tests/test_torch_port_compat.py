"""PyTorch port: the reference-name surface (``compat.py``, the top-level
names, ``models.mish``, ``data.load_split``, ``compare``'s ``dtype=``) and
Flax ``.msgpack`` checkpoints read without Flax, held against the JAX
package on the same numpy inputs.

Layouts: the reference's ``(B, 1, H, W)`` goes through both packages (the
JAX functions read the last two axes, which are (H, W) there); on
``(B, H, W, 1)`` the port must equal itself on the squeezed ``(B, H, W)``,
because the JAX plain stencils run over (W, C) of that layout.

Tolerances: losses rtol 2e-5 (``tests/test_reference_parity.py``), their
gradients atol 1e-6·max|g| + rtol 1e-5 and the PDE operators atol 1e-6
(``tests/test_pallas.py``), metrics atol 1e-6 with Hausdorff equal, the
float32 forward 2e-6 and the bf16 forward 2e-3
(``tests/test_torch_port_serve.py``).

The ``.msgpack`` fixtures under ``torch_port_data/`` are written by the JAX
package's ``save_params``: a seeded base-4 U-Net in float32 and in bf16,
and the JAX Predictor's outputs on a seeded ``(2, 1, 32, 32)`` input.
:func:`write_fixtures` makes them (``python tests/test_torch_port_compat.py``
rewrites them) and a test holds them byte for byte.
"""

import io
import subprocess
import sys
import warnings
import zipfile
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import physics_informed_image_segmentation_tpu as jax_pkg
import physics_informed_image_segmentation_tpu_torch as port
from physics_informed_image_segmentation_tpu import compat as jax_compat
from physics_informed_image_segmentation_tpu.data import load_split as jax_load_split
from physics_informed_image_segmentation_tpu.models import UNet as JaxUNet
from physics_informed_image_segmentation_tpu.models import mish as jax_mish
from physics_informed_image_segmentation_tpu.ops import losses as jax_losses
from physics_informed_image_segmentation_tpu.serve import Predictor as JaxPredictor
from physics_informed_image_segmentation_tpu.train import save_params as jax_save_params
from physics_informed_image_segmentation_tpu_torch import compat
from physics_informed_image_segmentation_tpu_torch.data import (
    load_split,
    make_blobs,
    write_synthetic_coco,
)
from physics_informed_image_segmentation_tpu_torch.experiments import compare
from physics_informed_image_segmentation_tpu_torch.models import UNet, mish
from physics_informed_image_segmentation_tpu_torch.ops import losses, physics_kernel
from physics_informed_image_segmentation_tpu_torch.serve import Predictor
from physics_informed_image_segmentation_tpu_torch.train.checkpoint import load_params
from physics_informed_image_segmentation_tpu_torch.utils.flax_msgpack import msgpack_restore
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "torch_port_data"
HW = 32
LOSS_RTOL, OP_ATOL, METRIC_ATOL = 2e-5, 1e-6, 1e-6
GRAD_ATOL_REL, GRAD_RTOL = 1e-6, 1e-5
FWD_ATOL, BF16_ATOL = 2e-6, 2e-3

# the reference implementation's 31 public names (tests/test_compat.py)
REFERENCE_ALL = [
    "CellSegmentationDataset",
    "UNet",
    "DiceBCELoss",
    "DiceBCEPDELoss",
    "PDERegularization",
    "create_pde_regularization",
    "compute_dice_score",
    "compute_dice_score_batch",
    "EarlyStopping",
    "train_stage",
    "validate",
    "train",
    "plot_training_curves",
    "plot_two_stage_comparison",
    "plot_all_metrics",
    "plot_training_results",
    "compute_iou",
    "compute_iou_batch",
    "compute_boundary_f1",
    "compute_boundary_f1_batch",
    "compute_hausdorff_distance",
    "evaluate_model",
    "evaluate_on_test_set",
    "compare_models_statistically",
    "format_metric_report",
    "compute_statistics",
    "evaluate_and_compare",
    "run_repeated_evaluations",
    "AblationConfig",
    "run_ablation_variant",
    "run_ablation_study",
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- fixtures


def fixture_params() -> dict:
    """A base-4 U-Net's parameters from numpy (seed 2024): kernels with
    variance 1/fan-in, biases of 0.05 standard deviation."""
    template = JaxUNet(base_channels=4, dtype=jnp.float32).init(
        jax.random.key(0), jnp.zeros((1, HW, HW, 1), jnp.float32))
    rng = np.random.default_rng(2024)

    def draw(a):
        if a.ndim == 4:
            return (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(
                np.float32)
        return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map(draw, template)


def _write_npz(path: Path, arrays: dict) -> None:
    """``np.savez`` with fixed entry times, so equal arrays give equal bytes."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name, a in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(a), allow_pickle=False)
            zf.writestr(zipfile.ZipInfo(f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0)),
                        buf.getvalue())


def write_fixtures(directory: Path) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    params = fixture_params()
    jax_save_params(params, directory / "unet_b4_f32.msgpack")
    jax_save_params(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params),
                    directory / "unet_b4_bf16.msgpack")
    x = np.random.default_rng(7).uniform(size=(2, 1, HW, HW)).astype(np.float32)
    expected = {"input": x}
    for precision in ("f32", "bf16"):
        predictor = JaxPredictor(directory / f"unet_b4_{precision}.msgpack", batch_size=2,
                                 image_size=(HW, HW), precision=precision, base_channels=4)
        expected[precision] = predictor.predict(x.transpose(0, 2, 3, 1))
    _write_npz(directory / "unet_b4_expected.npz", expected)


FIXTURES = ("unet_b4_f32.msgpack", "unet_b4_bf16.msgpack", "unet_b4_expected.npz")


def _assert_stored_outputs(ours, stored, precision):
    """The JAX Predictor's outputs against the stored ones.  XLA's CPU code
    may sum in another order on another host: float32 within 1e-7, bf16
    within one bf16 ulp of the larger value."""
    if precision == "f32":
        np.testing.assert_allclose(ours, stored, atol=1e-7, rtol=0)
        return
    big = np.maximum(np.abs(ours), np.abs(stored))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, np.finfo(np.float32).tiny))) - 7)
    assert np.all(np.abs(ours - stored) <= ulp), float(np.abs(ours - stored).max())


def test_fixtures_are_what_the_jax_package_writes(tmp_path):
    write_fixtures(tmp_path)
    for name in FIXTURES[:2]:
        assert (tmp_path / name).read_bytes() == (DATA / name).read_bytes(), name
    ours, stored = np.load(tmp_path / FIXTURES[2]), np.load(DATA / FIXTURES[2])
    assert sorted(ours.files) == sorted(stored.files) == ["bf16", "f32", "input"]
    np.testing.assert_array_equal(ours["input"], stored["input"])
    for precision in ("f32", "bf16"):
        _assert_stored_outputs(ours[precision], stored[precision], precision)
    assert sum((DATA / n).stat().st_size for n in FIXTURES) < 1 << 20


# ------------------------------------------------------------------ names


@pytest.mark.parametrize("name", REFERENCE_ALL)
def test_reference_name_is_exported(name):
    assert name in port.__all__ and getattr(port, name) is not None


def test_port_exports_every_jax_top_level_name():
    assert len(set(REFERENCE_ALL)) == 31
    assert set(jax_pkg.__all__) <= set(port.__all__)
    assert {"UNet", "count_parameters", "LossConfig", "make_loss_and_components",
            "train"} <= set(port.__all__)
    for sub in ("data", "experiments", "models", "ops", "parallel", "train", "utils"):
        assert f"{port.__name__}.{sub}" in sys.modules
    # as in the JAX package, the function ``train`` takes the subpackage's name
    assert port.train is sys.modules[f"{port.__name__}.train"].train
    assert port.CellSegmentationDataset is port.data.CocoSegmentationSource
    assert port.compute_dice_score is port.dice_score
    assert port.compute_hausdorff_distance is port.hausdorff_distance_np


_LIGHT_IMPORT = """
import sys
from pathlib import Path
sys.modules["matplotlib"] = None  # as on a machine without them
sys.modules["msgpack"] = None
import physics_informed_image_segmentation_tpu_torch as p
import torch.distributed as dist
heavy = sorted(m for m in ("matplotlib", "msgpack", "PIL", "scipy", "jax", "flax")
               if sys.modules.get(m) is not None)
from physics_informed_image_segmentation_tpu_torch.train.checkpoint import load_params
sd = load_params(Path(sys.argv[1]) / "unet_b4_bf16.msgpack")
print(len(p.__all__), heavy, dist.is_initialized(), len(sd))
"""


def test_import_is_light_and_msgpack_needs_no_package():
    """Without matplotlib and msgpack the package imports, loads no PIL,
    SciPy or JAX, sets up no process group, and reads a ``.msgpack``."""
    out = subprocess.run([sys.executable, "-c", _LIGHT_IMPORT, str(DATA)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(port.__all__)), "[]", "False",
                                  str(len(UNet(base_channels=4).state_dict()))]


# -------------------------------------------------- losses on both layouts


def _pair(seed, shape=(2, 1, 16, 20)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.02, 0.98, size=shape).astype(np.float32)
    target = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    return pred, target


WEIGHTS = [(0.1, 0.1), (1e-3, 0.0), (0.0, 1e-3), (0.0, 0.0)]


@pytest.mark.parametrize("pde_w,pf_w", WEIGHTS)
def test_losses_on_the_reference_layout_match_jax(pde_w, pf_w):
    """``ops.losses`` on (B, 1, H, W): the loss, its components and K1's
    plain version against the JAX functions, which read (H, W) there."""
    p, t = _pair(0)
    kw = dict(pde_weight=pde_w, phase_field_weight=pf_w, diffusion_coeff=2.0)
    ref = float(jax_losses.dice_bce_pde_loss(jnp.asarray(p), jnp.asarray(t), **kw))
    ours = losses.dice_bce_pde_loss(torch.tensor(p), torch.tensor(t), **kw)
    assert np.isfinite(float(ours))
    np.testing.assert_allclose(float(ours), ref, rtol=LOSS_RTOL)
    ref_c = jax_losses.loss_components(jnp.asarray(p), jnp.asarray(t), **kw)
    comps = losses.loss_components(torch.tensor(p), torch.tensor(t), **kw)
    fused = physics_kernel.fused_loss_components(
        torch.tensor(p), torch.tensor(t), diffusion_coeff=2.0, need_pde=pde_w > 0,
        need_phase_field=pf_w > 0)
    for k, v in ref_c.items():
        np.testing.assert_allclose(float(comps[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(float(fused[k]), float(v), rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_channel_layouts_equal_the_squeezed_field(layout):
    p, t = _pair(1, (3, 12, 14))
    axis = 1 if layout == "nchw" else 3
    kw = dict(pde_weight=0.1, phase_field_weight=0.1, diffusion_coeff=2.0)
    flat = losses.dice_bce_pde_loss(torch.tensor(p), torch.tensor(t), **kw)
    ours = losses.dice_bce_pde_loss(torch.tensor(p).unsqueeze(axis),
                                    torch.tensor(t).unsqueeze(axis), **kw)
    np.testing.assert_allclose(float(ours), float(flat), rtol=1e-6, atol=0)
    mask = torch.tensor([1.0, 0.0, 1.0]).reshape(3, 1, 1, 1)
    masked = losses.loss_components(torch.tensor(p).unsqueeze(axis),
                                    torch.tensor(t).unsqueeze(axis), mask=mask, **kw)
    ref = losses.loss_components(torch.tensor(p), torch.tensor(t), mask=mask[..., 0], **kw)
    for k, v in ref.items():
        np.testing.assert_allclose(float(masked[k]), float(v), rtol=1e-6, atol=0, err_msg=k)


def test_other_4d_shapes_raise():
    p = torch.rand(2, 3, 8, 8)
    with pytest.raises(ValueError, match="B, 1, H, W"):
        losses.dice_bce_pde_loss(p, p)
    with pytest.raises(ValueError, match="B, 1, H, W"):
        physics_kernel.fused_loss_components(p, p)
    with pytest.raises(ValueError, match="B, 1, H, W"):
        compat.DiceBCEPDELoss(phase_field_weight=0.1)(p, p)


# ----------------------------------------------------------- compat classes


@pytest.mark.parametrize("pde_w,pf_w", WEIGHTS)
def test_dice_bce_pde_loss_class_matches_jax(pde_w, pf_w):
    p, t = _pair(2)
    kw = dict(pde_weight=pde_w, phase_field_weight=pf_w, diffusion_coeff=3.0,
              reaction_threshold=0.4, epsilon=0.1)
    jax_loss = jax_compat.DiceBCEPDELoss(**kw)
    ref, ref_g = jax.value_and_grad(lambda x: jax_loss(x, jnp.asarray(t)))(jnp.asarray(p))
    loss = compat.DiceBCEPDELoss(**kw)
    pt = torch.tensor(p, requires_grad=True)
    ours = loss.forward(pt, torch.tensor(t))
    (g,) = torch.autograd.grad(ours, pt)
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=LOSS_RTOL)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * float(np.abs(ref_g).max()))
    nhwc = loss(torch.tensor(p).permute(0, 2, 3, 1), torch.tensor(t).permute(0, 2, 3, 1))
    np.testing.assert_allclose(float(nhwc), float(ours), rtol=1e-6, atol=0)


def test_dice_bce_loss_class_matches_jax():
    p, t = _pair(3)
    kw = dict(dice_weight=0.3, bce_weight=0.7, smooth=1e-5)
    ref = float(jax_compat.DiceBCELoss(**kw)(jnp.asarray(p), jnp.asarray(t)))
    np.testing.assert_allclose(float(compat.DiceBCELoss(**kw)(torch.tensor(p), torch.tensor(t))),
                               ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("method", ["compute_laplacian", "reaction_term", "compute_residual",
                                    "compute_loss", "compute_gradient_magnitude",
                                    "compute_phase_field_loss"])
def test_pde_regularization_matches_jax(method):
    u, _ = _pair(4)
    reg = compat.create_pde_regularization(diffusion_coeff=2.0, reaction_threshold=0.3)
    ref = np.asarray(getattr(jax_compat.PDERegularization(2.0, 0.3), method)(jnp.asarray(u)))
    ours = getattr(reg, method)(torch.tensor(u)).numpy()
    assert ours.shape == ref.shape
    # fields at the operators' atol; the two energies (means) are losses
    tol = dict(atol=OP_ATOL, rtol=0) if ref.ndim else dict(atol=0, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ours, ref, **tol)
    nhwc = getattr(reg, method)(torch.tensor(u).permute(0, 2, 3, 1)).numpy()
    np.testing.assert_allclose(nhwc, ref.transpose(0, 2, 3, 1) if ref.ndim == 4 else ref, **tol)


def test_parameter_checks_match_jax():
    for cls in (compat.PDERegularization, jax_compat.PDERegularization,
                compat.DiceBCEPDELoss, jax_compat.DiceBCEPDELoss):
        with pytest.raises(ValueError):
            cls(diffusion_coeff=0.0)
        with pytest.raises(ValueError):
            cls(reaction_threshold=1.5)
    u = torch.rand(1, 1, 8, 8)
    with pytest.raises(ValueError, match="epsilon"):
        compat.PDERegularization().compute_phase_field_loss(u, epsilon=0.0)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_compute_boundary_f1_matches_jax(batch, layout):
    images, masks = make_blobs(batch, HW, HW, seed=5)
    noise = np.random.default_rng(5).normal(scale=0.3, size=images.shape).astype(np.float32)
    pred = np.clip(masks + noise, 0, 1)
    if layout == "nchw":
        pred, masks = pred.transpose(0, 3, 1, 2), masks.transpose(0, 3, 1, 2)
    ref = float(jax_compat.compute_boundary_f1(jnp.asarray(pred), jnp.asarray(masks)))
    ours = float(compat.compute_boundary_f1(torch.tensor(pred), torch.tensor(masks)))
    np.testing.assert_allclose(ours, ref, atol=METRIC_ATOL)
    first = float(compat.compute_boundary_f1(torch.tensor(pred[:1]), torch.tensor(masks[:1])))
    assert ours == first


# --------------------------------------------------- evaluate_on_test_set


@pytest.fixture(scope="module")
def test_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("split")
    return write_synthetic_coco(root, n=6, height=48, width=56, seed=3)


@pytest.fixture(scope="module")
def jax_test_metrics(test_split):
    module = JaxUNet(base_channels=4, dtype=jnp.float32)
    return jax_compat.evaluate_on_test_set((module, fixture_params()), *test_split,
                                           batch_size=4, model_name="JAX")


@pytest.mark.parametrize("route", ["module", "predictor", "msgpack-predictor"])
def test_evaluate_on_test_set_matches_jax(route, test_split, jax_test_metrics):
    if route == "module":
        model = UNet(base_channels=4)
        model.load_state_dict(state_dict_from_jax(fixture_params()))
    else:
        name = "model.msgpack" if route == "msgpack-predictor" else "model.pth"
        path = test_split[0].parent / name
        if route == "predictor":
            torch.save(state_dict_from_jax(fixture_params()), path)
        else:
            jax_save_params(fixture_params(), path)
        model = Predictor(path, base_channels=4, precision="f32", device="cpu")
    ours = compat.evaluate_on_test_set(model, *test_split, "cpu", 4, model_name="port")
    assert set(ours) == set(jax_test_metrics)
    for k in ("dice_scores", "iou_scores", "boundary_f1_scores"):
        np.testing.assert_allclose(ours[k], jax_test_metrics[k], atol=METRIC_ATOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(ours["hausdorff_distances"],
                                  jax_test_metrics["hausdorff_distances"])


def test_evaluate_on_test_set_warns_for_a_bf16_predictor(test_split):
    predictor = Predictor(DATA / "unet_b4_bf16.msgpack", base_channels=4, device="cpu")
    with pytest.warns(UserWarning, match="bfloat16"):
        out = compat.evaluate_on_test_set(predictor, *test_split, device="cpu")
    assert np.isfinite(out["dice_scores"]).all()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        compat.evaluate_on_test_set(predictor, *test_split, device="cpu", dtype="bf16")
    with pytest.raises(TypeError, match="checkpoint path"):
        compat.evaluate_on_test_set(object(), *test_split, device="cpu")


# ------------------------------------------ mish, load_split, compare's dtype


def test_mish_matches_jax():
    """atol 1e-6 plus rtol 1e-6: beyond |x| of about 4, where mish(x) is
    nearly x, float32 outputs are a few ulp (4.8e-7 each at 8) apart."""
    x = torch.linspace(-20, 20, 4001)
    ours = mish(x).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_mish(x.numpy())), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ours, torch.nn.Mish()(x).numpy(), atol=1e-6, rtol=1e-6)


def test_load_split_matches_jax(test_split):
    ours = load_split(*test_split, image_size=(40, 48))
    ref = jax_load_split(*test_split, image_size=(40, 48))
    assert ours.image_ids == ref.image_ids
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.masks, ref.masks)


def test_compare_takes_dtype(tmp_path):
    path = tmp_path / "m.pth"
    torch.save(state_dict_from_jax(fixture_params()), path)
    model, _ = compare.load_unet_params(path, base_channels=4, dtype="f32", device="cpu")
    assert isinstance(model, UNet)


@pytest.mark.parametrize("fn", ["load_unet_params", "evaluate_and_compare",
                                "run_repeated_evaluations"])
def test_compare_rejects_disagreeing_precision_and_dtype(fn):
    args = {"load_unet_params": ("m.pth",),
            "evaluate_and_compare": ("a.pth", "b.pth", "d", "j"),
            "run_repeated_evaluations": (["a.pth"], ["b.pth"], "d", "j")}[fn]
    with pytest.raises(TypeError, match="disagree"):
        getattr(compare, fn)(*args, precision="bf16", dtype="f32", device="cpu")


# ------------------------------------------------------ the msgpack reader


def _tree():
    rng = np.random.default_rng(9)
    return {
        "params": {
            "conv": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                     "bias": rng.standard_normal(4).astype(np.float32)},
            "half": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16),
            "large": rng.standard_normal((200, 100)).astype(np.float32),
            "f64": rng.standard_normal(7),
        },
        "counts": np.arange(-3, 40, dtype=np.int32),
        "i64": np.array([2**40, -2**40], np.int64),
        "step": np.int32(12),
        "scale": np.float32(0.5),
        "flag": np.bool_(True),
        "ints": [0, 127, 128, -32, -33, 255, 256, 65536, -129, -40000, 2**33, -2**33, 2**63],
        "floats": [0.25, -1.5e300],
        "text": "a" * 40 + "é",
        "long text": "b" * 300,
        "many": {f"k{i:02d}": i for i in range(20)},
        "list": list(range(20)),
        "none": None,
        "yes": True,
        "no": False,
    }


def _same(ours, ref, where="tree"):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), where
        for k in ref:
            _same(ours[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert isinstance(ours, torch.Tensor), where
        assert tuple(ours.shape) == np.shape(ref), where
        if ref.dtype == jnp.bfloat16:
            assert ours.dtype == torch.bfloat16, where
            np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))
        else:
            assert str(ours.dtype) == f"torch.{np.dtype(ref.dtype).name}", where
            np.testing.assert_array_equal(ours.numpy(), ref, err_msg=where)
    else:
        assert type(ours) is type(ref) and ours == ref, where


def test_reader_matches_flax():
    data = flax.serialization.msgpack_serialize(_tree())
    _same(msgpack_restore(data), flax.serialization.msgpack_restore(data))
    _same(msgpack_restore(data), msgpack.unpackb(data, ext_hook=flax.serialization
                                                 ._msgpack_ext_unpack, raw=False))


@pytest.mark.parametrize("name", ["unet_b4_f32.msgpack", "unet_b4_bf16.msgpack"])
def test_reader_matches_flax_on_the_fixtures(name):
    data = (DATA / name).read_bytes()
    _same(msgpack_restore(data), flax.serialization.msgpack_restore(data))


def test_reader_refuses_what_it_does_not_know(monkeypatch):
    with pytest.raises(ValueError, match="ext code 5"):
        msgpack_restore(msgpack.packb({"x": msgpack.ExtType(5, b"abc")}))
    with pytest.raises(ValueError, match="ext code 2"):
        msgpack_restore(flax.serialization.msgpack_serialize({"z": complex(1, 2)}))
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    chunked = flax.serialization.msgpack_serialize({"w": np.zeros(100, np.float32)})
    with pytest.raises(ValueError, match="chunked"):
        msgpack_restore(chunked)
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(msgpack.packb({"x": [1, 2, 3]})[:-1])
    with pytest.raises(ValueError, match="left after"):
        msgpack_restore(msgpack.packb(1) + b"\x00")


@pytest.mark.parametrize("precision,atol", [("f32", FWD_ATOL), ("bf16", BF16_ATOL)])
def test_predictor_from_jax_msgpack_matches_the_jax_predictor(precision, atol):
    path = DATA / f"unet_b4_{precision}.msgpack"
    expected = np.load(DATA / "unet_b4_expected.npz")
    images = expected["input"].transpose(0, 2, 3, 1)
    kw = dict(batch_size=2, image_size=(HW, HW), precision=precision, base_channels=4)
    ref = JaxPredictor(path, **kw).predict(images)
    _assert_stored_outputs(ref, expected[precision], precision)
    ours = Predictor(path, device="cpu", **kw).predict(images)
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


def test_msgpack_leaves_keep_their_values():
    """bf16 leaves enter the float32 state dict at their exact values, and
    ``load_params`` takes the key layout of a model without dropout."""
    tree = msgpack_restore((DATA / "unet_b4_bf16.msgpack").read_bytes())
    sd = load_params(DATA / "unet_b4_bf16.msgpack")
    kernel = tree["params"]["enc1"]["conv1"]["kernel"]
    assert kernel.dtype == torch.bfloat16 and sd["enc1.conv.0.weight"].dtype == torch.float32
    torch.testing.assert_close(sd["enc1.conv.0.weight"], kernel.float().permute(3, 2, 0, 1),
                               rtol=0, atol=0)
    model = load_params(DATA / "unet_b4_f32.msgpack", UNet(base_channels=4, dropout=0.0))
    assert "enc3.conv.2.weight" in model.state_dict()


if __name__ == "__main__":
    write_fixtures(DATA)
