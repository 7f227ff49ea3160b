"""PyTorch port on the card: the fused physics-sums CUDA kernel against its
plain version, and the Stage II objective and train step through it.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these tests skip on a
machine without a GPU.  Run them on the card with
``python -m pytest --noconftest tests/test_torch_port_cuda.py -q``
(``tests/conftest.py`` imports JAX, which the GPU machine need not have).

Tolerances: the kernel and the plain version sum in float32 in different
orders (no atomics), so sums agree to rtol 1e-5 and gradients to
atol 1e-6·max|g| + rtol 1e-5.
"""

import pytest
import torch

from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K
from physics_informed_image_segmentation_tpu_torch.train.objective import (
    LossConfig,
    make_loss_and_components,
)

pytestmark = pytest.mark.cuda

D, A, EPS = 5.0, 0.5, 0.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(shape, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = 0.02 + 0.96 * torch.rand(shape, generator=g)
    t = (torch.rand(shape, generator=g) > 0.5).float()
    cot = torch.randn((shape[0], 6), generator=g)
    return u.to(device), t.to(device), cot.to(device)


def _grads(fn, u, t, m, cot, use_reaction):
    uu, tt = u.clone().requires_grad_(True), t.clone().requires_grad_(True)
    sums = fn(uu, tt, m, D, A, EPS, use_reaction)
    return (sums.detach(), *torch.autograd.grad(sums, (uu, tt), cot))


@pytest.mark.parametrize("shape,use_reaction", [
    ((8, 128, 128), True), ((2, 512, 512), True), ((3, 17, 23), True), ((2, 64, 64), False),
])
def test_kernel_matches_plain_version(cuda, shape, use_reaction):
    u, t, cot = _case(shape, cuda)
    m = torch.ones((shape[0], 1), device=cuda)
    ks, kdu, kdt = _grads(K.FusedPhysicsSums.apply, u, t, m, cot, use_reaction)
    ps, pdu, pdt = _grads(K.fused_physics_sums_reference, u, t, m, cot, use_reaction)
    torch.cuda.synchronize()
    assert torch.all((ks - ps).abs() <= 1e-5 * ps.abs())
    for k, p in ((kdu, pdu), (kdt, pdt)):
        assert torch.all((k - p).abs() <= 1e-6 * p.abs().max() + 1e-5 * p.abs())


def test_masked_slots_and_launch_counts(cuda):
    u, t, cot = _case((4, 32, 32), cuda, seed=1)
    m = torch.tensor([[1.0], [0.0], [1.0], [0.0]], device=cuda)
    K.reset_launch_counts()
    sums, du, dt = _grads(K.fused_physics_sums, u, t, m, cot, True)
    torch.cuda.synchronize()
    assert K.launch_counts == {"physics_sums_fwd": 1, "physics_sums_bwd": 1}
    assert torch.all(sums[1] == 0) and torch.all(du[1] == 0) and torch.all(dt[3] == 0)


def test_forward_repeats_bit_for_bit(cuda):
    u, t, _ = _case((8, 128, 128), cuda, seed=2)
    m = torch.ones((8, 1), device=cuda)
    a = K.fused_physics_sums(u, t, m, D, A, EPS)
    b = K.fused_physics_sums(u, t, m, D, A, EPS)
    assert torch.equal(a, b)


def test_objective_goes_through_the_kernel(cuda):
    u, t, _ = _case((4, 64, 64, 1), cuda, seed=3)
    kw = dict(pde_weight=1e-4, phase_field_weight=1e-4, diffusion_coeff=D, epsilon=EPS)
    K.reset_launch_counts()
    total, comps = make_loss_and_components(LossConfig(**kw))(u.requires_grad_(True), t)
    total.backward()
    assert K.launch_counts == {"physics_sums_fwd": 1, "physics_sums_bwd": 1}
    ref_total, _ = make_loss_and_components(LossConfig(backend="torch", **kw))(u.detach(), t)
    assert abs(float(total.detach()) - float(ref_total)) <= 1e-5 * abs(float(ref_total))


def test_wrapper_rejects_mixed_devices(cuda):
    u, t, _ = _case((2, 8, 8), cuda)
    with pytest.raises(ValueError):
        K.fused_physics_sums(u, t, torch.ones((2, 1)), D, A, EPS)
