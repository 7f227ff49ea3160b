"""PyTorch port: physics stencils, losses and the fused physics-sums kernel's
plain version, held against the JAX package on the same numpy inputs.

The JAX side runs its Pallas kernel through the Pallas interpreter on the
CPU, as its own tests do.  Tolerances are the JAX package's own bars
(tests/test_pallas.py): sums and loss values rtol 1e-5, gradients atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.ops import losses as jax_losses
from physics_informed_image_segmentation_tpu.ops import pallas_physics as jax_pp
from physics_informed_image_segmentation_tpu.ops import pde as jax_pde
from physics_informed_image_segmentation_tpu.train.objective import (
    LossConfig as JaxLossConfig,
    make_loss_and_components as jax_make_loss,
)
from physics_informed_image_segmentation_tpu_torch.ops import losses, pde, physics_kernel
from physics_informed_image_segmentation_tpu_torch.train.objective import (
    LossConfig,
    make_loss_and_components,
)

D, A, EPS = 5.0, 0.5, 0.05
PARAMS = dict(diffusion_coeff=D, reaction_threshold=A, epsilon=EPS)


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.02, 0.98, size=shape).astype(np.float32)
    target = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    return pred, target


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


def _total(c):
    return (0.5 * c["dice_loss"] + 0.5 * c["bce_loss"]
            + 1e-4 * c["pde_loss"] + 1e-4 * c["phase_field_loss"])


class TestStencils:
    @pytest.mark.parametrize("name", ["laplacian", "gradient_magnitude_sq", "pde_residual",
                                      "reflect_pad"])
    def test_matches_jax(self, name):
        u, _ = _pair(0, (2, 9, 13))
        ours = getattr(pde, name)(_t(u)).numpy()
        ref = np.asarray(getattr(jax_pde, name)(jnp.asarray(u)))
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)

    def test_losses_match_jax(self):
        u, _ = _pair(1, (2, 12, 12))
        np.testing.assert_allclose(
            float(pde.pde_residual_loss(_t(u), D, A)),
            float(jax_pde.pde_residual_loss(jnp.asarray(u), D, A)), rtol=1e-5)
        np.testing.assert_allclose(
            float(pde.phase_field_loss(_t(u), EPS)),
            float(jax_pde.phase_field_loss(jnp.asarray(u), EPS)), rtol=1e-5)

    def test_validate_params(self):
        with pytest.raises(ValueError):
            pde.validate_pde_params(0.0, 0.5)
        with pytest.raises(ValueError):
            pde.validate_pde_params(1.0, 1.0)


class TestPlainKernelSums:
    @pytest.mark.parametrize("shape,use_reaction", [
        ((3, 16, 16), True), ((3, 17, 23), True), ((2, 16, 12), False),
    ])
    def test_sums_match_pallas(self, shape, use_reaction):
        u, t = _pair(2, shape)
        m = np.array([[1.0], [0.0], [1.0]][: shape[0]], np.float32)
        ours = physics_kernel.fused_physics_sums(_t(u), _t(t), _t(m), D, A, EPS, use_reaction)
        ref = jax_pp.fused_physics_sums(
            jnp.asarray(u), jnp.asarray(t), jnp.asarray(m), D, A, EPS, use_reaction)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=0)

    @pytest.mark.parametrize("shape,use_reaction", [
        ((2, 8, 8), True), ((1, 16, 12), True), ((3, 17, 23), True), ((2, 10, 10), False),
    ])
    def test_grads_match_pallas_vjp(self, shape, use_reaction):
        """du and dt of the loss, including boundary rows and columns."""
        u, t = _pair(3, shape)
        t = np.clip(t, 0.1, 0.9)  # a differentiable point for dt
        kw = dict(PARAMS, use_reaction_term=use_reaction)
        gu_ref, gt_ref = jax.grad(
            lambda p, q: _total(jax_pp.fused_loss_components(p, q, **kw)), (0, 1)
        )(jnp.asarray(u), jnp.asarray(t))
        ut, tt = _t(u, True), _t(t, True)
        _total(physics_kernel.fused_loss_components(ut, tt, **kw)).backward()
        gu_ref, gt_ref = np.asarray(gu_ref), np.asarray(gt_ref)
        for ours, ref in ((ut.grad.numpy(), gu_ref), (tt.grad.numpy(), gt_ref)):
            for edge in (np.s_[:, 0, :], np.s_[:, -1, :], np.s_[:, :, 0], np.s_[:, :, -1],
                         np.s_[:, 1, :], np.s_[:, -2, :], np.s_[:, :, 1], np.s_[:, :, -2]):
                np.testing.assert_allclose(ours[edge], ref[edge], atol=1e-6)
            np.testing.assert_allclose(ours, ref, atol=1e-6)

    @pytest.mark.parametrize("term", ["pde_loss", "phase_field_loss"])
    def test_physics_term_grads_match_pure_jax(self, term):
        """Each physics term's adjoint against jax.grad of the pure stencils."""
        u, t = _pair(4, (1, 8, 8))
        pure = {"pde_loss": lambda p: jax_pde.pde_residual_loss(p, D, A),
                "phase_field_loss": lambda p: jax_pde.phase_field_loss(p, EPS)}[term]
        ref = np.asarray(jax.grad(pure)(jnp.asarray(u)))
        ut = _t(u, True)
        physics_kernel.fused_loss_components(ut, _t(t), **PARAMS)[term].backward()
        np.testing.assert_allclose(ut.grad.numpy(), ref, atol=1e-6)

    def test_masked_slots_get_exactly_zero_gradient(self):
        u, t = _pair(5, (3, 8, 8))
        mask = torch.tensor([1.0, 0.0, 1.0]).reshape(3, 1, 1)
        ut, tt = _t(u, True), _t(t, True)
        c = physics_kernel.fused_loss_components(ut, tt, mask=mask, **PARAMS)
        (c["dice_loss"] + c["bce_loss"] + c["pde_loss"] + c["phase_field_loss"]).backward()
        assert torch.all(ut.grad[1] == 0) and torch.all(tt.grad[1] == 0)
        assert ut.grad[0].abs().max() > 0

    def test_saturated_predictions_finite(self):
        u = np.tile(np.array([[0.0, 1.0], [0.5, 0.25]], np.float32), (4, 4))[None]
        t = np.ones_like(u)
        ut = _t(u, True)
        comps = physics_kernel.fused_loss_components(ut, _t(t), **PARAMS)
        ref = jax_pp.fused_loss_components(jnp.asarray(u), jnp.asarray(t), **PARAMS)
        for k in comps:
            assert np.isfinite(float(comps[k].detach())), k
            np.testing.assert_allclose(float(comps[k].detach()), float(ref[k]), rtol=1e-5,
                                       err_msg=k)
        _total(comps).backward()
        assert torch.isfinite(ut.grad).all()

    def test_channel_dim_and_disabled_terms(self):
        u, t = _pair(6, (2, 12, 12))
        a = physics_kernel.fused_loss_components(_t(u)[..., None], _t(t)[..., None], **PARAMS)
        b = physics_kernel.fused_loss_components(_t(u), _t(t), **PARAMS)
        assert float(a["pde_loss"]) == float(b["pde_loss"])
        c = physics_kernel.fused_loss_components(
            _t(u), _t(t), need_pde=False, need_phase_field=False, **PARAMS)
        assert float(c["pde_loss"]) == 0.0 and float(c["phase_field_loss"]) == 0.0

    @pytest.mark.parametrize("bad", ["dtype", "shape", "mask_shape", "contiguous"])
    def test_wrapper_rejects_bad_inputs(self, bad):
        u, t = (torch.rand(2, 8, 8) for _ in range(2))
        m = torch.ones(2, 1)
        if bad == "dtype":
            u = u.double()
        elif bad == "shape":
            t = t[:, :4]
        elif bad == "mask_shape":
            m = torch.ones(2)
        else:
            u = u.transpose(1, 2)
        with pytest.raises((TypeError, ValueError)):
            physics_kernel.fused_physics_sums(u, t, m, D, A, EPS)

    def test_kernel_function_refuses_cpu_tensors(self):
        u = torch.rand(1, 4, 4)
        with pytest.raises(ValueError):
            physics_kernel.FusedPhysicsSums.apply(u, u, torch.ones(1, 1), D, A, EPS, True)
        assert physics_kernel.launch_counts == {"physics_sums_fwd": 0, "physics_sums_bwd": 0}


@pytest.mark.parametrize("jax_backend", ["jax", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("port", ["objective", "fused"])
def test_loss_matches_jax(jax_backend, masked, port):
    """make_loss_and_components: values and gradients against both JAX backends.

    The JAX plain backend takes (B, H, W) here: on (B, H, W, 1) it runs its
    stencils over (W, C) (see test_channel_axis_is_not_a_stencil_axis).
    """
    shape = (4, 12, 12, 1) if jax_backend == "pallas" else (4, 12, 12)
    u, t = _pair(7, shape)
    mask_np = None
    if masked:
        mask_np = np.array([1, 1, 1, 0], np.float32).reshape((4,) + (1,) * (len(shape) - 1))
    kw = dict(pde_weight=1e-3, phase_field_weight=1e-3, **PARAMS)
    jax_fn = jax_make_loss(JaxLossConfig(backend=jax_backend, **kw))

    def jax_total(p):
        mask = None if mask_np is None else jnp.asarray(mask_np)
        return jax_fn(p, jnp.asarray(t), mask)

    (ref_total, ref_comps), ref_grad = jax.value_and_grad(jax_total, has_aux=True)(jnp.asarray(u))

    ut = _t(u, True)
    mask = None if mask_np is None else _t(mask_np)
    if port == "objective":
        total, comps = make_loss_and_components(LossConfig(backend="torch", **kw))(ut, _t(t), mask)
    else:
        comps = physics_kernel.fused_loss_components(ut, _t(t), mask=mask, **PARAMS)
        total = 0.5 * comps["dice_loss"] + 0.5 * comps["bce_loss"] + 1e-3 * (
            comps["pde_loss"] + comps["phase_field_loss"])
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=1e-5)
    for k in ref_comps:
        np.testing.assert_allclose(float(comps[k].detach()), float(ref_comps[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(ref_grad), atol=1e-6)


def test_channel_axis_is_not_a_stencil_axis():
    """On (B, H, W, 1) the port's plain path equals its (B, H, W) result and
    the JAX Pallas path; the JAX plain path differs there (a fault of the
    JAX package, recorded in ROADMAP.md)."""
    u, t = _pair(10, (2, 12, 12, 1))
    kw = dict(pde_weight=1e-3, phase_field_weight=1e-3, **PARAMS)
    fn = make_loss_and_components(LossConfig(backend="torch", **kw))
    four = fn(_t(u), _t(t))[1]["pde_loss"]
    three = fn(_t(u[..., 0]), _t(t[..., 0]))[1]["pde_loss"]
    pallas = jax_make_loss(JaxLossConfig(backend="pallas", **kw))(
        jnp.asarray(u), jnp.asarray(t))[1]["pde_loss"]
    jax_plain = jax_make_loss(JaxLossConfig(backend="jax", **kw))(
        jnp.asarray(u), jnp.asarray(t))[1]["pde_loss"]
    np.testing.assert_allclose(float(four), float(three), rtol=1e-6)
    np.testing.assert_allclose(float(four), float(pallas), rtol=1e-5)
    assert abs(float(jax_plain) - float(pallas)) > 1e-2 * float(pallas)


def test_stage1_objective_and_diffusion_only():
    u, t = _pair(8, (2, 10, 10))
    for kw in ({}, dict(pde_weight=1e-3, use_reaction_term=False, **PARAMS)):
        ours, oc = make_loss_and_components(LossConfig(**kw))(_t(u), _t(t))
        ref, rc = jax_make_loss(JaxLossConfig(backend="jax", **kw))(jnp.asarray(u), jnp.asarray(t))
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
        np.testing.assert_allclose(float(oc["pde_loss"]), float(rc["pde_loss"]), rtol=1e-5)


def test_cuda_backend_raises_on_cpu_tensors():
    u, t = _pair(9, (2, 8, 8, 1))
    for kw in ({}, dict(pde_weight=1e-4)):
        fn = make_loss_and_components(LossConfig(backend="cuda", **kw))
        with pytest.raises(ValueError, match="CUDA"):
            fn(_t(u), _t(t))
    with pytest.raises(ValueError):
        LossConfig(backend="pallas")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_reaction", [True, False])
def test_combined_losses_match_jax(masked, use_reaction):
    u, t = _pair(11, (3, 10, 10))
    mask_np = np.array([1, 0, 1], np.float32).reshape(3, 1, 1) if masked else None
    mask = None if mask_np is None else _t(mask_np)
    jmask = None if mask_np is None else jnp.asarray(mask_np)
    kw = dict(pde_weight=1e-3, phase_field_weight=1e-3, use_reaction_term=use_reaction, **PARAMS)
    ours = losses.dice_bce_pde_loss(_t(u), _t(t), mask=mask, **kw)
    ref = jax_losses.dice_bce_pde_loss(jnp.asarray(u), jnp.asarray(t), mask=jmask, **kw)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    np.testing.assert_allclose(
        float(losses.dice_bce_loss(_t(u), _t(t), mask=mask)),
        float(jax_losses.dice_bce_loss(jnp.asarray(u), jnp.asarray(t), mask=jmask)), rtol=1e-5)
