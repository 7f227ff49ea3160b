"""PyTorch port: the halo-padded physics op (K3's plain version) and the halo
losses across gloo processes, held against the JAX package.

* K3's plain version against the JAX ``padded_physics_sums`` (its Pallas
  kernel through the interpreter on the CPU): sums rtol 1e-5, gradients
  atol 1e-6 on the whole padded block, ghost ring included — the bars of
  tests/test_pallas.py.  The gradient is that of a mean, so its scale is
  that of the losses' gradients.
* Blocks of a field cut into row bands with mirrored ghost rows at the
  global edges, through K3's plain version, against K1's plain version on
  the whole field, in one process: the check chip_smoke.py makes of the
  kernels on the card, with its band and fold helpers.
* The halo losses on 2 and 4 gloo processes (rows sharded; and batch ×
  rows on 2×2) against the JAX package's unsharded ``pde_residual_loss``
  and ``phase_field_loss``: values rtol 1e-6 and gradients atol 1e-6, as
  tests/test_parallel.py holds them; ``halo_physics_loss_pallas`` values
  rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.ops import pallas_physics as jax_pp
from physics_informed_image_segmentation_tpu.ops import pde as jax_pde
from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3
from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K1
from torch_port_dist_worker import launch

from chip_smoke import bands_with_ghosts, fold_bands  # the checks chip_smoke.py makes

D, A, EPS = 5.0, 0.5, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _padded(seed, shape, saturated=False):
    rng = np.random.default_rng(seed)
    if saturated:
        return (rng.integers(0, 3, size=shape) / 2.0).astype(np.float32)  # {0, 0.5, 1}
    return rng.uniform(0.02, 0.98, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape,use_reaction,saturated", [
    ((2, 18, 26), True, False),
    ((2, 18, 26), False, False),
    ((1, 4, 130), True, False),     # H_loc = 2, the smallest band
    ((3, 9, 35), True, True),       # W+2 = 35: no multiple of a warp
])
def test_plain_version_matches_jax_padded_sums(shape, use_reaction, saturated):
    p = _padded(0, shape, saturated)
    b, hp, wp = shape
    n = b * (hp - 2) * (wp - 2)
    cot = (np.random.default_rng(1).normal(size=(b, 2)) / n).astype(np.float32)

    ref, vjp = jax.vjp(lambda q: jax_pp.padded_physics_sums(q, D, A, EPS, use_reaction),
                       jnp.asarray(p))
    (ref_grad,) = vjp(jnp.asarray(cot))
    pt = torch.tensor(p, requires_grad=True)
    sums = K3.padded_physics_sums(pt, D, A, EPS, use_reaction)
    (grad,) = torch.autograd.grad(sums, pt, torch.tensor(cot))

    np.testing.assert_allclose(sums.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=0)
    ref_grad, grad = np.asarray(ref_grad), grad.numpy()
    for ring in (np.s_[:, 0, :], np.s_[:, -1, :], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(grad[ring], ref_grad[ring], atol=1e-6)
    np.testing.assert_allclose(grad, ref_grad, atol=1e-6)
    corners = grad[:, [0, 0, -1, -1], [0, -1, 0, -1]]
    assert np.all(corners == 0.0), "cross-shaped taps never reach the corners"


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_its_input():
    p = torch.tensor(_padded(2, (2, 6, 7)))
    K3.reset_launch_counts()
    torch.testing.assert_close(K3.padded_physics_sums(p, D, A, EPS),
                               K3.padded_physics_sums_reference(p, D, A, EPS), rtol=0, atol=0)
    assert K3.launch_counts == {"padded_physics_fwd": 0, "padded_physics_bwd": 0}
    with pytest.raises(TypeError):
        K3.padded_physics_sums(p.double(), D, A, EPS)
    with pytest.raises(ValueError):
        K3.padded_physics_sums(p[0], D, A, EPS)
    with pytest.raises(ValueError):
        K3.padded_physics_sums(p.transpose(1, 2), D, A, EPS)
    with pytest.raises(ValueError):
        K3.PaddedPhysicsSums.apply(p, D, A, EPS, True)  # the kernel takes CUDA tensors


@pytest.mark.parametrize("use_reaction", [True, False])
def test_bands_through_k3_match_k1_on_the_whole_field(use_reaction):
    shape = (2, 32, 24)
    u = torch.tensor(_padded(3, shape))
    cot = torch.tensor(np.random.default_rng(4).normal(size=(2, 2)).astype(np.float32)) / u.numel()

    ut = u.clone().requires_grad_(True)
    t = torch.zeros(shape)
    sums = K1.fused_physics_sums_reference(ut, t, torch.ones((2, 1)), D, A, EPS, use_reaction)
    cot6 = torch.zeros((2, 6))
    cot6[:, 4:] = cot
    (du_ref,) = torch.autograd.grad(sums, ut, cot6)

    blocks = [b.requires_grad_(True) for b in bands_with_ghosts(u, 4)]
    band_sums = [K3.padded_physics_sums(b, D, A, EPS, use_reaction) for b in blocks]
    total = torch.stack(band_sums).sum(0)
    grads = torch.autograd.grad(total, blocks, cot)
    np.testing.assert_allclose(total.detach().numpy(), sums[:, 4:].detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(fold_bands(grads, 4, shape).numpy(), du_ref.numpy(), atol=1e-6)


def _halo_inputs(tmp_path, shape, data, space, batch_axis):
    rng = np.random.default_rng(7)
    u = rng.uniform(0.05, 0.95, size=shape).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", u=u, D=2.0, a=A, eps=EPS, data=data, space=space,
             batch_axis=int(batch_axis), use_reaction=1)
    return u


def _assemble(outs, key, shape, data, space):
    full = np.zeros(shape, np.float32)
    bl, hl = shape[0] // data, shape[1] // space
    for o in outs:
        d, s = int(o["data_rank"]), int(o["space_rank"])
        full[d * bl:(d + 1) * bl, s * hl:(s + 1) * hl] = o[key]
    return full


@pytest.mark.parametrize("world", [2, 4])
def test_halo_losses_across_ranks_match_unsharded_jax(tmp_path, world):
    shape = (2, 32, 16)
    u = _halo_inputs(tmp_path, shape, data=1, space=world, batch_axis=False)
    outs = launch("halo", tmp_path, world)

    ju = jnp.asarray(u)
    rd_fn = lambda v: jax_pde.pde_residual_loss(v, 2.0, A)
    pf_fn = lambda v: jax_pde.phase_field_loss(v, EPS)
    for o in outs:  # every rank holds the global loss
        np.testing.assert_allclose(float(o["rd"]), float(rd_fn(ju)), rtol=1e-6)
        np.testing.assert_allclose(float(o["pf"]), float(pf_fn(ju)), rtol=1e-6)
        np.testing.assert_allclose(float(o["fused_rd"]), float(rd_fn(ju)), rtol=1e-5)
        np.testing.assert_allclose(float(o["fused_pf"]), float(pf_fn(ju)), rtol=1e-5)
    for key, fn in (("rd_grad", rd_fn), ("pf_grad", pf_fn),
                    ("fused_grad", lambda v: rd_fn(v) + 0.5 * pf_fn(v))):
        ref = np.asarray(jax.grad(fn)(ju))
        np.testing.assert_allclose(_assemble(outs, key, shape, 1, world), ref, atol=1e-6,
                                   err_msg=key)


def test_halo_physics_over_batch_and_rows_matches_unsharded_jax(tmp_path):
    """``batch_axis="data"`` on a 2×2 mesh: the means over the global batch."""
    shape = (4, 32, 16)
    u = _halo_inputs(tmp_path, shape, data=2, space=2, batch_axis=True)
    outs = launch("halo", tmp_path, 4)

    ju = jnp.asarray(u)
    rd_fn = lambda v: jax_pde.pde_residual_loss(v, 2.0, A)
    pf_fn = lambda v: jax_pde.phase_field_loss(v, EPS)
    for o in outs:
        np.testing.assert_allclose(float(o["fused_rd"]), float(rd_fn(ju)), rtol=1e-5)
        np.testing.assert_allclose(float(o["fused_pf"]), float(pf_fn(ju)), rtol=1e-5)
    ref = np.asarray(jax.grad(lambda v: rd_fn(v) + 0.5 * pf_fn(v))(ju))
    np.testing.assert_allclose(_assemble(outs, "fused_grad", shape, 2, 2), ref, atol=1e-6)
