"""PyTorch port on the card: the fused physics-sums CUDA kernel (K1), the
fused AdamW kernel (K2), the halo-padded physics kernel (K3) and the 3x3
convolution kernels (K4) against their plain versions, and the Stage II
objective, the train step, the halo physics loss, the Predictor, a
three-stage ablation variant, a batched study, TransUNet's channels-last
decoder (no NCHW batch-norm kernel, no layout transpose but around the
one-channel head), the GroupNorm kernels of its ResNet against float64
and on the model's path, the reference's
``DiceBCEPDELoss`` (``compat.py``), the int8 convolution of
``scripts/quant_probe.py`` (exact against float64) and the burn-in's
deterministic launch (bit-equal across two processes) on the card.

Marked ``cuda``: a CUDA kernel has no CPU mode, so these tests skip on a
machine without a GPU.  Run them on the card with
``python -m pytest --noconftest tests/test_torch_port_cuda.py -q``
(``tests/conftest.py`` imports JAX, which the GPU machine need not have).

Tolerances: the kernel and the plain version sum in float32 in different
orders (no atomics), so sums agree to rtol 1e-5 and gradients to
atol 1e-6·max|g| + rtol 1e-5 (K1 and K3 alike).  K2 rounds every
operation as its plain version does, so the two must be bit-equal.  K4 in
float32: forward rtol 1e-5 / atol 1e-5, gradients rtol 1e-4 / atol 1e-4
(the bars of ``tests/test_pallas_conv.py``); in bf16 both accumulate in
float32 and round once, so they are within one bf16 rounding (rtol 2^-7,
atol 1e-2).
"""

import json
import re

import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu_torch.ops import conv_kernel as K4
from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3
from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K
from physics_informed_image_segmentation_tpu_torch.train import adamw_kernel as K2
from physics_informed_image_segmentation_tpu_torch.train import engine
from physics_informed_image_segmentation_tpu_torch.train.objective import (
    LossConfig,
    make_loss_and_components,
)
from physics_informed_image_segmentation_tpu_torch.train.optim import AdamW

pytestmark = pytest.mark.cuda

D, A, EPS = 5.0, 0.5, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
    # tiles: H and W of 2 to 5, shapes that end inside a tile both ways, wide rows
    ((2, 2, 2), True), ((1, 2, 5), False), ((3, 3, 3), True), ((1, 3, 4), True),
    ((2, 4, 2), False), ((1, 4, 4), True), ((2, 5, 5), True), ((3, 130, 70), True),
    ((2, 24, 1000), True), ((1, 3, 4096), True), ((2, 37, 101), False), ((1, 66, 2), True),
])
def test_kernel_matches_plain_version(cuda, shape, use_reaction):
    u, t, cot = _case(shape, cuda)
    m = torch.ones((shape[0], 1), device=cuda)
    if shape[0] == 3:
        m[1] = 0.0
    ks, kdu, kdt = _grads(K.FusedPhysicsSums.apply, u, t, m, cot, use_reaction)
    ps, pdu, pdt = _grads(K.fused_physics_sums_reference, u, t, m, cot, use_reaction)
    tdu, tdt = K.fused_physics_sums_bwd_tiled(u, t, m, cot, D, A, EPS, use_reaction)
    torch.cuda.synchronize()
    assert torch.all((ks - ps).abs() <= 1e-5 * ps.abs())
    for k, p in ((kdu, pdu), (kdt, pdt), (kdu, tdu), (kdt, tdt)):
        assert torch.all((k - p).abs() <= 1e-6 * p.abs().max() + 1e-5 * p.abs())
    # without dt the same du, and nothing written in dt's place
    du_only, none = K._launch_bwd(u, t, m, cot, D, A, EPS, use_reaction, need_dt=False)
    assert none is None and torch.equal(du_only, kdu)


@pytest.mark.parametrize("shape", [(8, 128, 128), (3, 130, 70), (2, 5, 5)])
def test_kernels_replay_in_a_cuda_graph(cuda, shape):
    """Forward and backward captured once and replayed on fresh inputs are
    bit-equal to the eager calls: the forward's last block leaves its
    ticket at zero, and the backward needs no scratch."""
    args = (D, A, EPS, True)
    u, t, cot = _case(shape, cuda, seed=20)
    m = torch.ones((shape[0], 1), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K._launch_fwd(u, t, m, *args)  # the stream's workspace, made outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        sums = K._launch_fwd(u, t, m, *args)
        du, dt = K._launch_bwd(u, t, m, cot, *args, need_dt=True)
    for seed in (21, 22, 23):
        u2, t2, cot2 = _case(shape, cuda, seed=seed)
        u.copy_(u2), t.copy_(t2), cot.copy_(cot2)
        graph.replay()
        torch.cuda.synchronize()
        eager = (K._launch_fwd(u2, t2, m, *args), *K._launch_bwd(u2, t2, m, cot2, *args,
                                                                need_dt=True))
        torch.cuda.synchronize()
        for a, b in zip((sums, du, dt), eager):
            assert torch.equal(a, b)


def test_shared_memory_formula_is_the_kernels(cuda):
    for tile_h in (8, 16, 32):
        for bwd in (False, True):
            assert K._library().physics_sums_shared_bytes(tile_h, int(bwd)) == K.shared_bytes(
                tile_h, bwd)


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


def test_forward_on_two_streams_keeps_a_workspace_each(cuda):
    u, t, _ = _case((8, 128, 128), cuda, seed=2)
    m = torch.ones((8, 1), device=cuda)
    ref = K.fused_physics_sums(u, t, m, D, A, EPS)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(K.fused_physics_sums(u, t, m, D, A, EPS))
    torch.cuda.synchronize()
    assert all(torch.equal(o, ref) for o in outs)


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


def _adamw_pair(shapes, device, steps=3, seed=0, offset=0):
    """K2 and the plain AdamW over the same params and gradients of varied
    scale; with ``offset`` every tensor starts that many floats into its
    buffer (16-byte misalignment for offset 1)."""
    g = torch.Generator().manual_seed(seed)

    def on_card(x):
        buf = torch.empty(x.numel() + offset, device=device)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        return view

    params = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * 10.0 ** -float(k) for s in shapes]
             for k in range(steps)]
    opts = []
    for cls in (K2.FusedAdamW, AdamW):
        opt = cls([on_card(p) for p in params], 1e-3, 1e-5)
        opt.m = [on_card(x) for x in opt.m]
        opt.v = [on_card(x) for x in opt.v]
        for gs in grads:
            opt.step([on_card(x) for x in gs])
        opts.append(opt)
    torch.cuda.synchronize()
    return opts


@pytest.mark.parametrize("shapes,offset,launches", [
    ([(1,), (3,), (64,), (1023,), (4097,), (65537,), (3, 3, 7, 5)], 0, 1),
    ([(1,), (3,), (64,), (1023,), (4097,), (65537,), (3, 3, 7, 5)], 1, 1),
    ([(0,), (5,)], 0, 1),
    ([(i + 1,) for i in range(65)], 0, 2),
    ([(3, 3, 512, 512), (512,)], 0, 1),
])
def test_adamw_kernel_bit_equal_to_plain_version(cuda, shapes, offset, launches):
    K2.reset_launch_counts()
    kernel, plain = _adamw_pair(shapes, cuda, offset=offset)
    assert K2.launch_counts["adamw"] == 3 * launches
    for a, b in zip(kernel.params + kernel.m + kernel.v, plain.params + plain.m + plain.v):
        assert torch.equal(a, b)


def test_adamw_plan_is_kept_and_made_anew_for_a_replaced_tensor(cuda):
    shapes = [(3, 3, 64, 64), (64,), (4097,), (5,)]
    g = torch.Generator().manual_seed(9)
    params = [torch.randn(s, generator=g).to(cuda) for s in shapes]
    kernel = K2.FusedAdamW([p.clone() for p in params], 1e-3, 1e-5)
    plain = AdamW([p.clone() for p in params], 1e-3, 1e-5)

    def step():
        grads = [torch.randn(s, generator=g).to(cuda) for s in shapes]  # fresh tensors
        kernel.step([x.clone() for x in grads])
        plain.step(grads)

    K2.reset_launch_counts()
    plans = []
    for _ in range(4):
        step()
        plans.append(kernel._plan)
    assert all(p is plans[0] for p in plans) and K2.launch_counts["adamw"] == 4
    old = kernel.params[0]
    kept = old.clone()
    kernel.params[0] = old.clone()
    step()
    torch.cuda.synchronize()
    assert kernel._plan is not plans[0] and torch.equal(old, kept)
    kernel.load_state_dict(kernel.state_dict())
    assert kernel._plan is None
    step()
    torch.cuda.synchronize()
    for a, b in zip(kernel.params + kernel.m + kernel.v, plain.params + plain.m + plain.v):
        assert torch.equal(a, b)


def test_adamw_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    p, m, v = (torch.zeros(4, 4, device=cuda) for _ in range(3))
    with pytest.raises(ValueError, match="contiguous"):
        K2.fused_adamw_([p], [torch.zeros(4, 4, device=cuda).t()], [m], [v], 0.1, 1e-3, 1e-3, 0.0)
    with pytest.raises(TypeError, match="float32"):
        K2.fused_adamw_([p], [torch.zeros(4, 4, device=cuda, dtype=torch.float64)], [m], [v],
                        0.1, 1e-3, 1e-3, 0.0)
    with pytest.raises(ValueError, match="is on"):
        K2.fused_adamw_([p], [torch.zeros(4, 4)], [m], [v], 0.1, 1e-3, 1e-3, 0.0)


def test_pallas_adamw_train_step_goes_through_the_kernel(cuda):
    """One Stage II step with "pallas_adamw" launches K2 once and matches
    "adamw" bit for bit (f32, deterministic cuDNN, same dropout seed)."""
    from physics_informed_image_segmentation_tpu_torch.models import UNet

    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    try:
        x, y, _ = _case((4, 64, 64, 1), cuda, seed=4)
        y = (y > 0.5).float()
        step = engine.make_train_step_fn(LossConfig(pde_weight=1e-4, phase_field_weight=1e-4),
                                         precision="f32")
        params = {}
        for name in ("adamw", "pallas_adamw"):
            model = UNet(base_channels=8, generator=torch.Generator().manual_seed(0)).to(cuda)
            state = engine.create_train_state(model, 1e-3, optimizer=name, dropout_seed=1)
            K2.reset_launch_counts()
            step(state, x, y, torch.ones(4, device=cuda))
            torch.cuda.synchronize()
            assert K2.launch_counts["adamw"] == (name == "pallas_adamw")
            params[name] = [p.detach() for p in model.parameters()]
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = old
    for a, b in zip(params["adamw"], params["pallas_adamw"]):
        assert torch.equal(a, b)


def _k3_grads(fn, p, cot, use_reaction):
    pp = p.clone().requires_grad_(True)
    sums = fn(pp, D, A, EPS, use_reaction)
    return sums.detach(), torch.autograd.grad(sums, pp, cot)[0]


def _k3_case(shape, device, seed=5, saturated=False):
    g = torch.Generator().manual_seed(seed)
    if saturated:
        p = torch.randint(0, 3, shape, generator=g).float() / 2.0
    else:
        p = 0.02 + 0.96 * torch.rand(shape, generator=g)
    return p.to(device), torch.randn((shape[0], 2), generator=g).to(device)


@pytest.mark.parametrize("shape,use_reaction,saturated", [
    ((1, 1026, 1026), True, False), ((8, 130, 130), True, False), ((3, 37, 53), True, False),
    ((2, 4, 35), True, False), ((2, 18, 26), True, True), ((8, 130, 130), False, False),
    # odd pitch, interiors one pixel high or wide, nine images with ragged tiles
    ((3, 9, 35), True, False), ((2, 3, 130), True, False), ((3, 3, 3), False, False),
    ((2, 67, 3), True, False), ((9, 37, 131), True, False),
])
def test_padded_kernel_matches_plain_version(cuda, shape, use_reaction, saturated):
    p, cot = _k3_case(shape, cuda, saturated=saturated)
    ks, kdp = _k3_grads(K3.PaddedPhysicsSums.apply, p, cot, use_reaction)
    ps, pdp = _k3_grads(K3.padded_physics_sums_reference, p, cot, use_reaction)
    tdp = K3.padded_physics_sums_bwd_tiled(p, cot, D, A, EPS, use_reaction)
    torch.cuda.synchronize()
    assert torch.all((ks - ps).abs() <= 1e-5 * ps.abs())
    for ref in (pdp, tdp):
        assert torch.all((kdp - ref).abs() <= 1e-6 * ref.abs().max() + 1e-5 * ref.abs())
    assert torch.all(kdp[:, [0, 0, -1, -1], [0, -1, 0, -1]] == 0)


def test_padded_kernel_takes_a_misaligned_block(cuda):
    """A block 4 bytes off an 8-byte boundary goes in 4-byte copies, with
    the same answers."""
    p, cot = _k3_case((8, 130, 130), cuda, seed=9)
    view = torch.empty(p.numel() + 1, device=cuda)[1:].view(p.shape)
    view.copy_(p)
    assert K3.copy_bytes(view) == 4 and K3.copy_bytes(p) == 8
    for x in (p, view):
        assert K3._library().padded_physics_copy_bytes(x.data_ptr(), 130) == K3.copy_bytes(x)
    a = (K3._launch_fwd(p, D, A, EPS, True), K3._launch_bwd(p, cot, D, A, EPS, True))
    b = (K3._launch_fwd(view, D, A, EPS, True), K3._launch_bwd(view, cot, D, A, EPS, True))
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("shape", [(1, 1026, 1026), (8, 130, 130), (9, 37, 131)])
def test_padded_kernels_replay_in_a_cuda_graph(cuda, shape):
    """Forward and backward captured once and replayed on fresh inputs are
    bit-equal to the eager calls, which repeat bit for bit."""
    args = (D, A, EPS, True)
    p, cot = _k3_case(shape, cuda, seed=30)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K3._launch_fwd(p, *args)  # the stream's workspace, made outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        sums = K3._launch_fwd(p, *args)
        dp = K3._launch_bwd(p, cot, *args)
    for seed in (31, 32, 33):
        p2, cot2 = _k3_case(shape, cuda, seed=seed)
        p.copy_(p2), cot.copy_(cot2)
        graph.replay()
        torch.cuda.synchronize()
        for _ in range(2):
            eager = (K3._launch_fwd(p2, *args), K3._launch_bwd(p2, cot2, *args))
            torch.cuda.synchronize()
            assert torch.equal(sums, eager[0]) and torch.equal(dp, eager[1])


@pytest.mark.parametrize("shape", [(1, 1026, 1026), (8, 130, 130)])
def test_padded_kernel_is_one_device_kernel_a_call(cuda, shape):
    from torch.profiler import ProfilerActivity, profile

    p, cot = _k3_case(shape, cuda, seed=40)
    K3._launch_fwd(p, D, A, EPS, True)  # the stream's workspace
    torch.cuda.synchronize()
    for fn in (lambda: K3._launch_fwd(p, D, A, EPS, True),
               lambda: K3._launch_bwd(p, cot, D, A, EPS, True)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and "padded_" in e.name]
        others = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and "padded_" not in e.name
                  and not getattr(e, "is_user_annotation", False)]
        assert len(kernels) == 1 and not others, (len(kernels), others)


def test_padded_shared_memory_formula_is_the_kernels(cuda):
    for tile_h in (1, 8, 16, 32):
        for bwd in (False, True):
            assert K3._library().padded_physics_shared_bytes(tile_h, int(bwd)) == K3.shared_bytes(
                tile_h, bwd)


def test_padded_kernel_counts_repeats_and_checks(cuda):
    p = (0.02 + 0.96 * torch.rand((8, 130, 130), generator=torch.Generator().manual_seed(6)))
    p = p.to(cuda)
    K3.reset_launch_counts()
    a, _ = _k3_grads(K3.padded_physics_sums, p, torch.ones((8, 2), device=cuda), True)
    b = K3.padded_physics_sums(p, D, A, EPS)
    torch.cuda.synchronize()
    assert K3.launch_counts == {"padded_physics_fwd": 2, "padded_physics_bwd": 1}
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        K3.padded_physics_sums(p.double(), D, A, EPS)
    with pytest.raises(ValueError):
        K3.padded_physics_sums(p.transpose(1, 2), D, A, EPS)


def test_halo_physics_loss_goes_through_the_padded_kernel(cuda):
    """World 1 on NCCL: both means from one K3 launch each way, equal to
    the plain physics losses."""
    import torch.distributed as dist

    from physics_informed_image_segmentation_tpu_torch.ops import pde
    from physics_informed_image_segmentation_tpu_torch.parallel import (
        halo_physics_loss_pallas,
        initialize_distributed,
        make_mesh,
    )

    initialize_distributed()
    try:
        mesh = make_mesh()
        u = (0.05 + 0.9 * torch.rand((2, 64, 48), generator=torch.Generator().manual_seed(7)))
        u = u.to(cuda).requires_grad_(True)
        K3.reset_launch_counts()
        rd, pf = halo_physics_loss_pallas(u, mesh, D, A, EPS)
        (rd + pf).backward()
        torch.cuda.synchronize()
        assert K3.launch_counts == {"padded_physics_fwd": 1, "padded_physics_bwd": 1}
        ref_rd, ref_pf = pde.pde_residual_loss(u, D, A), pde.phase_field_loss(u, EPS)
        assert abs(float(rd.detach()) - float(ref_rd)) <= 1e-5 * abs(float(ref_rd))
        assert abs(float(pf.detach()) - float(ref_pf)) <= 1e-5 * abs(float(ref_pf))
    finally:
        dist.destroy_process_group()


def _k4_case(shape, dtype, device, seed=8):
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, w, cin), generator=g).to(dtype)
    wt = (torch.randn((3, 3, cin, cout), generator=g) * 0.1).to(dtype)
    cot = (torch.randn((b, h, w, cout), generator=g) * 0.1).to(dtype)
    return x.to(device), wt.to(device), cot.to(device)


def _k4_grads(fn, x, wt, cot, paired):
    xx, ww = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    out = fn(xx, ww, paired)
    return (out.detach(), *torch.autograd.grad(out, (xx, ww), cot))


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("shape,dtype", [
    ((8, 128, 128, 64, 64), torch.bfloat16), ((2, 16, 16, 8, 8), torch.float32),
    ((1, 8, 32, 4, 12), torch.float32), ((2, 44, 64, 16, 24), torch.float32),
    ((2, 44, 64, 16, 24), torch.bfloat16), ((1, 16, 32, 72, 136), torch.float32),
    ((1, 20, 24, 8, 8), torch.float32), ((2, 16, 16, 8, 8), torch.bfloat16),
    ((1, 20, 24, 80, 136), torch.bfloat16), ((2, 16, 16, 16, 24), torch.bfloat16),
    # the wgmma kernels: one tile, an image smaller than a tile, ragged tiles
    # below and above the number of SMs, a second channel chunk each way, dW alone
    ((1, 8, 16, 64, 64), torch.bfloat16), ((2, 5, 8, 64, 64), torch.bfloat16),
    ((2, 44, 72, 64, 64), torch.bfloat16),
    ((3, 72, 136, 64, 64), torch.bfloat16), ((1, 20, 24, 128, 64), torch.bfloat16),
    ((1, 16, 32, 64, 128), torch.bfloat16), ((1, 16, 16, 192, 64), torch.bfloat16),
])
def test_conv_kernel_matches_plain_version(cuda, shape, dtype, paired):
    x, wt, cot = _k4_case(shape, dtype, cuda)
    # the Function takes any W; the public function keeps the JAX contract
    kernel = _k4_grads(K4.Conv3x3Same.apply, x, wt, cot, paired)
    plain = _k4_grads(K4.conv3x3_same_reference, x, wt, cot, paired)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        bars = [(1e-5, 1e-5), (1e-4, 1e-4), (1e-4, 1e-4)]
    else:
        bars = [(2.0 ** -7, 1e-2)] * 3
    for k, p, (rtol, atol) in zip(kernel, plain, bars):
        assert k.dtype == dtype and k.shape == p.shape
        assert torch.all((k.float() - p.float()).abs() <= atol + rtol * p.float().abs())


@pytest.mark.parametrize("shape,dtype,sets", [
    ((8, 128, 128, 64, 64), torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    ((2, 44, 72, 64, 64), torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    ((1, 20, 24, 128, 64), torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    ((1, 16, 32, 64, 128), torch.bfloat16, ("wgmma", "wgmma", "wgmma")),
    ((1, 16, 16, 192, 64), torch.bfloat16, ("wmma", "wgmma", "wgmma")),
    ((2, 16, 16, 16, 24), torch.bfloat16, ("wmma", "cuda-cores", "wmma")),
    ((2, 16, 16, 16, 24), torch.float32, ("cuda-cores", "cuda-cores", "cuda-cores")),
    ((2, 16, 16, 64, 64), torch.float32, ("cuda-cores", "cuda-cores", "cuda-cores")),
])
def test_conv_kernel_set_follows_the_operands(cuda, shape, dtype, sets):
    """The library picks the kernel set of the forward, of dx (a forward on
    the cotangent with Cin and Cout exchanged) and of dW by what the
    operands are, and a misaligned pointer takes the CUDA cores."""
    x, wt, cot = _k4_case(shape, dtype, cuda)
    w9 = wt.reshape(9, shape[3], shape[4])
    assert K4.kernel_set(x, w9) == sets[0]
    assert K4.kernel_set(cot, w9.transpose(1, 2).contiguous()) == sets[1]
    assert K4.kernel_set(x, cot, dw=True) == sets[2]
    if dtype == torch.bfloat16:
        flat = torch.zeros(x.numel() + 1, dtype=dtype, device=cuda)
        off = flat[1:].view(x.shape).copy_(x)  # 2 bytes past a 16-byte boundary
        assert K4.kernel_set(off, w9) == K4.kernel_set(off, cot, dw=True) == "cuda-cores"
        out = K4._launch_fwd(off, w9, False)
        dw = K4._launch_dw(off, cot)
        torch.cuda.synchronize()
        ref = K4.conv3x3_same_reference(x, wt)
        assert torch.all((out.float() - ref.float()).abs() <= 1e-2 + 2.0 ** -7 * ref.float().abs())
        assert dw.shape == (9, shape[3], shape[4]) and bool(torch.isfinite(dw).all())


def test_conv_on_the_card_runs_its_kernels_and_nothing_else(cuda, monkeypatch):
    """``conv3x3_same`` on CUDA tensors moves the launch counters and never
    reaches the plain version, ``F.conv2d``, ``matmul`` or ``einsum``."""
    x, wt, cot = _k4_case((2, 16, 16, 8, 8), torch.float32, cuda)
    ones = K4.conv3x3_same(torch.ones((1, 8, 16, 4), device=cuda),
                           torch.ones((3, 3, 4, 4), device=cuda))
    assert [float(ones[0, 4, 8, 0]), float(ones[0, 0, 8, 0]), float(ones[0, 0, 0, 0])] == [36, 24, 16]

    def forbidden(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached something other than the kernels")

    monkeypatch.setattr(K4, "conv3x3_same_reference", forbidden)
    monkeypatch.setattr(torch.nn.functional, "conv2d", forbidden)
    monkeypatch.setattr(torch, "matmul", forbidden)
    monkeypatch.setattr(torch, "einsum", forbidden)
    monkeypatch.setattr(torch.Tensor, "__matmul__", forbidden)
    K4.reset_launch_counts()
    first = _k4_grads(K4.conv3x3_same, x, wt, cot, False)
    assert K4.launch_counts == {"conv3x3_fwd": 2, "conv3x3_fwd_paired": 0, "conv3x3_dw": 1}
    _k4_grads(K4.conv3x3_same, x, wt, cot, True)
    assert K4.launch_counts == {"conv3x3_fwd": 2, "conv3x3_fwd_paired": 2, "conv3x3_dw": 2}
    again = _k4_grads(K4.conv3x3_same, x, wt, cot, False)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)  # no atomics: a run repeats bit for bit


def test_conv_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, wt, _ = _k4_case((1, 8, 8, 8, 8), torch.float32, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K4.conv3x3_same(x.double(), wt.double())
    with pytest.raises(ValueError, match="is on"):
        K4._launch_fwd(x, wt.reshape(9, 8, 8).cpu(), False)
    with pytest.raises(ValueError, match="power-of-two W"):
        K4.conv3x3_same(x[:, :, :6], wt)
    with pytest.raises(ValueError, match=r"\(9, 8, Cout\)"):
        K4._launch_fwd(x, torch.zeros((9, 4, 8), device=cuda), False)
    with pytest.raises(ValueError, match="shared memory"):
        K4.conv3x3_same(torch.zeros((1, 8, 8, 256), device=cuda),
                        torch.zeros((3, 3, 256, 8), device=cuda))
    # the most input channels that fit: float32 on the CUDA cores, bf16 on
    # the tensor cores, in the row-major and the paired order
    for cin, paired, dtype in ((237, False, torch.float32), (188, True, torch.float32),
                               (432, False, torch.bfloat16), (336, True, torch.bfloat16)):
        xx, ww, cc = _k4_case((1, 8, 8, cin, 8), dtype, cuda)
        k = _k4_grads(K4.conv3x3_same, xx, ww, cc, paired)
        p = _k4_grads(K4.conv3x3_same_reference, xx, ww, cc, paired)
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0 ** -7, 1e-2)
        assert torch.all((k[0].float() - p[0].float()).abs() <= atol + rtol * p[0].float().abs())
        with pytest.raises(ValueError, match="shared memory"):
            K4.conv3x3_same(torch.zeros((1, 8, 8, cin + 16), dtype=dtype, device=cuda),
                            torch.zeros((3, 3, cin + 16, 8), dtype=dtype, device=cuda), paired)


def test_predictor_on_the_card(cuda, tmp_path):
    from physics_informed_image_segmentation_tpu_torch.data import make_blobs
    from physics_informed_image_segmentation_tpu_torch.models import UNet
    from physics_informed_image_segmentation_tpu_torch.serve import Predictor
    from physics_informed_image_segmentation_tpu_torch.train.checkpoint import save_params

    model = UNet(base_channels=8, generator=torch.Generator().manual_seed(0))
    save_params(model, tmp_path / "m.pth")
    p = Predictor(tmp_path / "m.pth", batch_size=4, image_size=(64, 64), precision="f32",
                  base_channels=8)
    assert p.device.type == "cuda"
    images = make_blobs(6, 64, 64, seed=0)[0]
    probs = p.predict(images)
    with torch.no_grad():
        ref = model.to(cuda).eval()(torch.as_tensor(images, device=cuda).permute(0, 3, 1, 2))
    # float32 without TF32 on both sides, other batch sizes
    assert abs(probs - ref.permute(0, 2, 3, 1).cpu().numpy()).max() <= 1e-5
    dev = p.predict_device(torch.as_tensor(images[:4], device=cuda))
    assert dev.is_cuda and abs(dev.cpu().numpy() - probs[:4]).max() <= 1e-5


def test_predictor_output_ring_on_the_card(cuda, tmp_path):
    """Twenty back-to-back requests of mixed sizes, each with a random
    threshold and no synchronisation between them, through the ring of two
    page-locked slots: every mask equals the host's threshold of the same
    images' probabilities, fetched afterwards.  A slot read before its copy
    landed, or written again before it was read, shows here and on no CPU."""
    from physics_informed_image_segmentation_tpu_torch.data import make_blobs
    from physics_informed_image_segmentation_tpu_torch.models import UNet
    from physics_informed_image_segmentation_tpu_torch.serve import Predictor
    from physics_informed_image_segmentation_tpu_torch.train.checkpoint import save_params

    b, hw = 128, 64
    model = UNet(base_channels=8, generator=torch.Generator().manual_seed(1))
    save_params(model, tmp_path / "m.pth")
    p = Predictor(tmp_path / "m.pth", batch_size=b, image_size=(hw, hw), precision="bf16",
                  base_channels=8)
    pool = make_blobs(800, hw, hw, seed=2)[0]
    rng = np.random.default_rng(3)
    requests = []
    for n in [1, 127, 128, 129, 670] * 4:
        start, t = int(rng.integers(0, len(pool) - n + 1)), float(rng.uniform(0.0, 1.0))
        before = dict(p.fetch_counts)
        masks = p.predict(pool[start:start + n], threshold=t)
        requests.append((start, n, t, masks, {k: v - before[k] for k, v in p.fetch_counts.items()}))
    for start, n, t, masks, counts in requests:
        probs = p.predict(pool[start:start + n])
        assert masks.shape == (n, hw, hw, 1) and masks.dtype == np.float32
        assert np.array_equal(masks, (probs > t).astype(np.float32)), (start, n, t)
        chunks = -(-n // b)
        assert counts == {"chunks": chunks, "masks_on_card": chunks, "overlapped": chunks - 1,
                          "host_bytes": chunks * b * hw * hw}, (n, counts)
        assert counts["overlapped"] > 0 or chunks == 1
    # the float32 payload through the ring is the device path's, bit for bit
    x = pool[:2 * b]
    dev = p.predict_device(torch.as_tensor(x, device=cuda))
    assert np.array_equal(p.predict(x), dev.cpu().numpy())


def test_three_stage_ablation_variant_on_the_card(cuda, tmp_path):
    """Base 8, 64x64, bf16: K1 runs in Stage II alone, forward on every
    train and validation batch, backward on every train step."""
    import json

    from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs
    from physics_informed_image_segmentation_tpu_torch.experiments import (
        AblationConfig,
        run_ablation_variant,
    )

    images, masks = make_blobs(28, 64, 64, seed=3)
    cut = lambda a, b: DeviceDataset.from_numpy(images[a:b], masks[a:b], "cuda")
    data = {"train": cut(0, 12), "val": cut(12, 20), "in_dist": cut(20, 24),
            "out_dist": cut(24, 28)}
    cfg = AblationConfig("C3 Three", "card", use_pde=True, use_three_stage=True,
                         stage1_epochs=2, stage2_epochs=2)
    K.reset_launch_counts()
    res = run_ablation_variant(cfg, datasets=data, batch_size=4, stage1_epochs=2,
                               stage2_epochs=2, early_stopping_patience=5,
                               ablation_folder=tmp_path, base_channels=8)
    steps, val_batches = 2 * 3, 2 * 2  # two Stage II epochs of 3 steps and 2 val batches
    assert K.launch_counts == {"physics_sums_fwd": steps + val_batches,
                               "physics_sums_bwd": steps}
    assert set(res["stage_comparison"]) == {"stage1_vs_stage2", "stage1_vs_stage3",
                                            "stage2_vs_stage3"}
    for key in ("in_dist_metrics", "pde_out_dist_metrics", "baseline_in_dist_metrics"):
        dice = np.asarray(res[key]["dice_scores"])
        assert dice.shape == (4,) and np.isfinite(dice).all()
    # as JSON text: a Hausdorff distance of an empty prediction is NaN
    saved = json.loads((tmp_path / "c3_three_results.json").read_text())
    assert json.dumps(saved, sort_keys=True) == json.dumps(res, sort_keys=True)
    for name in ("c3_three_baseline_after_stage1.pth", "c3_three_after_pde_stage2.pth",
                 "c3_three_after_stage3.pth"):
        assert (tmp_path / name).exists()


def test_batched_study_launches_k1_once_per_member(cuda, tmp_path):
    """Three S-shaped members at base 8, 64x64, bf16: Stage II runs the
    stack through vmap and K1 once a member, forward on every train and
    validation batch, backward on every train step; Stage I and the
    evaluations launch nothing."""
    import json

    from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs
    from physics_informed_image_segmentation_tpu_torch.experiments import (
        AblationConfig,
        run_batched_study,
    )

    images, masks = make_blobs(28, 64, 64, seed=4)
    cut = lambda a, b: DeviceDataset.from_numpy(images[a:b], masks[a:b], "cuda")
    data = {"train": cut(0, 12), "val": cut(12, 20), "in_dist": cut(20, 24),
            "out_dist": cut(24, 28)}
    members = [AblationConfig(f"CB.{i}", "card", use_pde=True, diffusion_coeff=d)
               for i, d in enumerate((1.0, 5.0, 10.0))]
    K.reset_launch_counts()
    res = run_batched_study("CB", members, datasets=data, batch_size=4, stage1_epochs=1,
                            stage2_epochs=2, early_stopping_patience=5, output_dir=tmp_path,
                            base_channels=8)
    steps, val_batches = 2 * 3, 2 * 2  # two Stage II epochs of 3 steps and 2 val batches
    assert K.launch_counts == {"physics_sums_fwd": 3 * (steps + val_batches),
                               "physics_sums_bwd": 3 * steps}
    assert res["stop_epochs"] == [2, 2, 2]
    saved = json.loads(open(res["results_json"]).read())
    assert saved["batched"] is True
    for member in saved["results"]:
        dice = np.asarray(member["in_dist_metrics"]["dice_scores"])
        assert dice.shape == (4,) and np.isfinite(dice).all()


def test_prefetch_to_device_on_the_card(cuda):
    """Pinned host memory and a side stream: the consumer sees every item,
    in order, with its values, on the card."""
    from physics_informed_image_segmentation_tpu_torch.data import prefetch_to_device

    items = [(np.full((4, 32, 32, 1), i, np.float32), np.arange(i, i + 4, dtype=np.float32))
             for i in range(9)]
    out = list(prefetch_to_device(iter(items), size=3, device="cuda"))
    assert len(out) == len(items)
    for (x, v), (tx, tv) in zip(items, out):
        assert tx.is_cuda and tv.is_cuda
        assert np.array_equal((tx * 2).cpu().numpy(), x * 2)
        assert np.array_equal(tv.cpu().numpy(), v)


def test_chunk_on_the_card_launches_no_optimizer_on_padding(cuda):
    """A chunk of 2 real and 2 padding steps with "pallas_adamw": K1 once
    each way and K2 once per real step, none on the padding."""
    from physics_informed_image_segmentation_tpu_torch.data import make_blobs
    from physics_informed_image_segmentation_tpu_torch.models import UNet

    images, masks = make_blobs(8, 32, 32, seed=0)
    xs = torch.tensor(images).reshape(4, 2, 32, 32, 1).to(cuda)
    ys = torch.tensor(masks).reshape(4, 2, 32, 32, 1).to(cuda)
    valids = torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 0.0], [0.0, 0.0]], device=cuda)
    model = UNet(base_channels=4, generator=torch.Generator().manual_seed(0)).to(cuda)
    state = engine.create_train_state(model, 1e-3, optimizer="pallas_adamw")
    chunk = engine.make_train_chunk_fn(LossConfig(pde_weight=1e-3, phase_field_weight=1e-4,
                                                  diffusion_coeff=D))
    K.reset_launch_counts()
    K2.reset_launch_counts()
    state, out = chunk(state, xs, ys, valids)
    torch.cuda.synchronize()
    assert state.step == 2 and K2.launch_counts["adamw"] == 2
    assert K.launch_counts == {"physics_sums_fwd": 2, "physics_sums_bwd": 2}
    assert out["n"].tolist() == [2.0, 1.0, 0.0, 0.0]
    assert bool(torch.isfinite(out["loss"][:2]).all()) and bool(torch.isnan(out["loss"][2:]).all())


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_compat_loss_launches_k1_once_each_way(cuda, layout):
    """The reference's ``DiceBCEPDELoss`` on CUDA tensors goes through K1 (one
    launch each way) and agrees with the same class on CPU tensors (its
    plain path) within K1's bars."""
    from physics_informed_image_segmentation_tpu_torch.compat import DiceBCEPDELoss

    g = torch.Generator().manual_seed(3)
    shape = (4, 1, 40, 36) if layout == "nchw" else (4, 40, 36, 1)
    pred = 0.02 + 0.96 * torch.rand(shape, generator=g)
    target = (torch.rand(shape, generator=g) > 0.5).float()
    loss_fn = DiceBCEPDELoss(pde_weight=1e-3, phase_field_weight=1e-3, diffusion_coeff=D)

    def value_and_grad(p, t):
        p = p.clone().requires_grad_(True)
        loss = loss_fn(p, t)
        return loss.detach().cpu(), torch.autograd.grad(loss, p)[0].cpu()

    K.reset_launch_counts()
    loss_k, grad_k = value_and_grad(pred.to(cuda), target.to(cuda))
    assert K.launch_counts == {"physics_sums_fwd": 1, "physics_sums_bwd": 1}
    loss_p, grad_p = value_and_grad(pred, target)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    assert torch.all((grad_k - grad_p).abs()
                     <= 1e-6 * grad_p.abs().max() + 1e-5 * grad_p.abs())


def test_remat_is_bit_equal_under_bf16_autocast_on_the_card(cuda):
    """``UNet(remat=True)`` against ``remat=False`` on the card under bf16
    autocast, training with dropout 0.2 from a generator on the card,
    deterministic cuDNN and TF32 off: the forward, the input's and every
    parameter's gradient bit-equal, the generator in the same state.  A
    recompute outside autocast, or with other dropout masks, would give
    other gradients."""
    from physics_informed_image_segmentation_tpu_torch.models import UNet

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = []
        for remat in (False, True):
            model = UNet(base_channels=16, remat=remat,
                         generator=torch.Generator().manual_seed(0)).to(cuda).train()
            gen = torch.Generator(device=cuda).manual_seed(7)
            x = torch.rand((2, 1, 64, 64), generator=torch.Generator().manual_seed(1))
            x = x.to(cuda).requires_grad_(True)
            w = torch.randn((2, 1, 64, 64), generator=torch.Generator().manual_seed(2)).to(cuda)
            with torch.autocast("cuda", dtype=torch.bfloat16):
                out = model(x, gen)
            (out * w).sum().backward()
            torch.cuda.synchronize()
            runs.append((out.detach(), x.grad, [p.grad for p in model.parameters()],
                         gen.get_state()))
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved
    (o1, x1, g1, s1), (o2, x2, g2, s2) = runs
    assert torch.equal(o1, o2) and torch.equal(x1, x2) and torch.equal(s1, s2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["k1", "k3"])
def test_bench_kernel_check_fails_loudly_on_a_wrong_plain_version(cuda, which):
    """The bench's kernel check passes against the true plain versions and
    raises when handed a plain version that is off by 1e-3 relative."""
    from physics_informed_image_segmentation_tpu_torch import bench

    errors = bench.kernel_check()
    assert set(errors) == {"k1_sums", "k1_grad", "k3_sums", "k3_grad"}
    plain = {"k1": K.fused_physics_sums_reference, "k3": K3.padded_physics_sums_reference}[which]
    wrong = {f"{which}_plain": lambda *args: plain(*args) * 1.001}
    with pytest.raises(RuntimeError, match=f"kernel_check: {which}"):
        bench.kernel_check(**wrong)


@pytest.mark.parametrize("shape,hi", [((2, 16, 16, 8, 16), 4), ((3, 5, 7, 24, 40), 127),
                                      ((2, 16, 16, 512, 512), 127)])
def test_int8_conv_on_the_card_is_exact(cuda, shape, hi):
    """``quant_probe``'s int8 convolution (im2col + ``torch._int_mm`` on the
    card, the weight matrix column-major) equals the float64 convolution
    of the same integers exactly."""
    from physics_informed_image_segmentation_tpu_torch.scripts import quant_probe

    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-hi, hi + 1, (b, h, w, cin), generator=g, dtype=torch.int8).to(cuda)
    k = torch.randint(-hi, hi + 1, (3, 3, cin, cout), generator=g, dtype=torch.int8).to(cuda)
    ref = quant_probe.conv3x3_reference(x, k)
    out = quant_probe.int8_conv3x3_same(x, k)
    assert out.dtype == torch.int32 and out.is_cuda
    assert torch.equal(out.double(), ref)


def test_deterministic_launch_is_bit_equal_across_processes(cuda, tmp_path):
    """The burn-in's deterministic launch (``use_deterministic_algorithms``,
    no warn-only) runs ``--ablation R1`` at base 8 through the CLI on the
    card without an operation raising, K1 on its physics variants, and two
    such processes give bit-equal aggregates."""
    from physics_informed_image_segmentation_tpu_torch.scripts import ablation_burnin as burnin

    cfg = burnin.Burnin(data_root=tmp_path / "data", work=tmp_path / "work", ablation="R1",
                        images=(8, 4, 4, 4), size=32, epochs=1, base_channels=8,
                        launch="deterministic")
    burnin.make_data(cfg)
    cfg.work.mkdir()
    line = burnin.twice(cfg, {"card": "test"}, "deterministic")
    assert line["equal_studies"] == 1 and line["max_abs_diff"] == 0.0
    runs = json.loads((cfg.work / "runs.json").read_text())
    for name in ("twice_deterministic_1", "twice_deterministic_2"):
        assert runs[name]["k1_launches"] == [{"physics_sums_fwd": 6, "physics_sums_bwd": 3}]


def test_transunet_decoder_launches_no_nchw_kernels(cuda):
    """A bf16 forward and backward of TransUNet's decoder and head at the
    published decoder widths (256², so a 16² token grid and skips at 32²,
    64² and 128²; skips and tokens float32 and NCHW, as the encoder gives
    them): PyTorch's NCHW batch-norm kernels (one block per channel) stay
    off, all ten convolution inputs are channels-last, and cuDNN transposes
    no activation between layouts.  It does transpose around the head's
    one-channel convolution (its output forward, its output's gradient for
    dgrad and wgrad), whose tensors are the same bytes in either layout.
    Prints the decoder's device kernels with their seconds."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from physics_informed_image_segmentation_tpu_torch.models import TransUNet

    size, b = 256, 2
    model = TransUNet(img_size=size).to(cuda).train()
    g = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randn(b, (size // 16) ** 2, 768, device=cuda, generator=g)
    features = [torch.randn(b, c, size // s, size // s, device=cuda, generator=g)
                for c, s in ((512, 8), (256, 4), (64, 2))]
    for t in (tokens, *features):
        t.requires_grad_(True)
    weights = [*model.decoder.parameters(), *model.segmentation_head.parameters()]
    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
        probs = model(torch.rand(b, 1, size, size, device=cuda, generator=g), g)
    assert model.layout_counts == {"nhwc": 10, "nchw": 0}
    assert probs.shape == (b, 1, size, size) and probs.is_contiguous()

    def step():
        with torch.autocast("cuda", torch.bfloat16):
            x = model.decoder(tokens, features, model.layout_counts)
            assert x.is_contiguous(memory_format=torch.channels_last)  # the head's input
            out = model.segmentation_head(x)
        torch.autograd.grad(out.float().square().mean(), [*weights, tokens, *features])

    step()  # cuDNN's plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    assert model.layout_counts == {"nhwc": 28, "nchw": 0}  # and the decoder's nine, twice
    seconds, transposes = Counter(), []
    head = list(model.segmentation_head[0].weight.shape)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            seconds[e.name] += e.device_time_total * 1e-6
        for k in e.kernels:
            if "nchwToNhwc" in k.name or "nhwcToNchw" in k.name:
                transposes.append((e.name, head in e.input_shapes))
    print(json.dumps(seconds.most_common(12)))
    nchw_bn = [n for n in seconds if ("batch_norm_collect_statistics_kernel" in n
                                       or "batch_norm_backward_kernel" in n)
               and "channels_last" not in n]
    assert any("channels_last" in n for n in seconds)
    assert not nchw_bn, nchw_bn
    assert len(transposes) <= 3 and all(on_head for _, on_head in transposes), transposes


# ---- GroupNorm, residual and ReLU (ops/group_norm.py, csrc/group_norm.cu) ----

def _resnet_norm_sites(device, size=1024):
    """Every GroupNorm call of TransUNet's ResNetV2 at ``size``² (batch 1,
    bf16 autocast), as ``(C, H, W, groups, eps, residual, relu, keep_dtype)``
    in call order: recorded from the model itself."""
    from physics_informed_image_segmentation_tpu_torch.models import TransUNet
    from physics_informed_image_segmentation_tpu_torch.models import transunet as T

    sites, real = [], T.group_norm_act

    def record(x, norm, counts, **kw):
        sites.append((*x.shape[1:], norm.num_groups, norm.eps, kw.get("residual") is not None,
                      kw.get("relu", True), kw.get("keep_dtype", False)))
        return real(x, norm, counts, **kw)

    model = TransUNet(img_size=size).to(device)
    T.group_norm_act = record
    try:
        with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
            model.transformer.embeddings.hybrid_model(
                torch.rand(1, 3, size, size, device=device), model.norm_counts)
    finally:
        T.group_norm_act = real
    return sites


def _gn_operands(site, dtype, device, batch, seed):
    c, h, w, groups, eps, residual, relu, keep = site
    out = dtype if keep else torch.float32
    g = torch.Generator(device=device).manual_seed(seed)
    # a conv output's scale and offset differ by channel
    scale = 0.5 + torch.rand(1, c, 1, 1, device=device, generator=g)
    x = torch.randn(batch, c, h, w, device=device, generator=g) * scale + 0.3
    weight = 1.0 + 0.2 * torch.randn(c, device=device, generator=g)
    bias = 0.1 * torch.randn(c, device=device, generator=g)
    r = torch.randn(batch, c, h, w, device=device, generator=g) if residual else None
    dy = torch.randn(batch, c, h, w, device=device, generator=g).to(out)
    return x.to(dtype), weight, bias, r, dy, out


def _gn_kernel(x, weight, bias, r, dy, groups, eps, relu, out):
    from physics_informed_image_segmentation_tpu_torch.ops.group_norm import GroupNormAct

    ins = [t.clone().requires_grad_(True) for t in (x, weight, bias) + ((r,) if r is not None
                                                                         else ())]
    y = GroupNormAct.apply(*ins[:3], ins[3] if r is not None else None, groups, eps, relu, out,
                           True)
    return y.detach(), torch.autograd.grad(y, ins, dy)


def _gn_reference(x, weight, bias, r, dy, groups, eps, relu, passed):
    """float64 GroupNorm (+ r), and its gradients through the ReLU's
    decisions ``passed``: a pre-activation within float32 rounding of 0 may
    fall either way in the kernel, and its gradient with it."""
    ins = [t.double().requires_grad_(True) for t in (x, weight, bias) + ((r,) if r is not None
                                                                          else ())]
    z = torch.nn.functional.group_norm(ins[0], groups, ins[1], ins[2], eps)
    if r is not None:
        z = z + ins[3]
    y = torch.where(passed, z, torch.zeros_like(z)) if relu else z
    return z.detach(), torch.autograd.grad(y, ins, dy.double())


def _gn_close(k, p, rtol, atol_rel):
    err = (k.double() - p).abs()
    return bool(torch.all(err <= atol_rel * p.abs().max() + rtol * p.abs())), float(err.max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_at_every_resnet_site(cuda, dtype):
    """The kernels against float64 at the shape of each of the 52 norms of
    the ResNet at 1024², batch 8 (15 distinct sites), forward and every
    gradient.  Tolerances: the output is one rounding of a float32 value
    (bf16: 2^-8, float32: 1e-5 relative) plus 1e-5 of the largest; the
    gradients 1e-5 relative plus 1e-5 of the largest, and one bf16 rounding
    for a bf16 dx; the residual's gradient exact.  The ReLU's decisions
    may differ from float64's only within 1e-5 of 0."""
    sites = _resnet_norm_sites(cuda)
    assert len(sites) == 52
    for i, site in enumerate(dict.fromkeys(sites)):
        c, h, w, groups, eps, residual, relu, keep = site
        x, weight, bias, r, dy, out = _gn_operands(site, dtype, cuda, 8, seed=100 + i)
        y, grads = _gn_kernel(x, weight, bias, r, dy, groups, eps, relu, out)
        passed = y > 0 if relu else None
        z, ref = _gn_reference(x, weight, bias, r, dy, groups, eps, relu, passed)
        assert y.dtype == out and grads[0].dtype == dtype
        y_ref = z.clamp_min(0) if relu else z
        ok_y, err_y = _gn_close(y, y_ref, 2.0 ** -8 if out == torch.bfloat16 else 1e-5, 1e-5)
        assert ok_y, (site, err_y)
        if relu:
            flipped = passed != (z > 0)
            assert bool(torch.all(z[flipped].abs() <= 1e-5)), (site, int(flipped.sum()))
        for name, k, p in zip(("dx", "dgamma", "dbeta"), grads, ref):
            rtol = 2.0 ** -8 if name == "dx" and dtype == torch.bfloat16 else 1e-5
            ok, err = _gn_close(k, p, rtol, 1e-5)
            assert ok, (site, name, err)
        if residual:
            assert grads[3].dtype == torch.float32 and torch.equal(grads[3].double(), ref[3])
        del x, y, z, grads, ref


def test_group_norm_kernel_takes_a_channels_last_gradient(cuda):
    """An upstream gradient in channels-last strides (a skip's, since the
    decoder runs NHWC) gives the same bits as the same values in NCHW."""
    site = (64, 255, 255, 32, 1e-6, False, True, True)
    x, weight, bias, r, dy, out = _gn_operands(site, torch.bfloat16, cuda, 2, seed=7)
    _, nchw = _gn_kernel(x, weight, bias, r, dy, 32, 1e-6, True, out)
    _, nhwc = _gn_kernel(x, weight, bias, r, dy.contiguous(memory_format=torch.channels_last),
                         32, 1e-6, True, out)
    for a, b in zip(nchw, nhwc):
        assert torch.equal(a, b)


def test_group_norm_kernel_bf16_copy_and_its_gradient(cuda):
    """On the residual stream (bf16 x, float32 y) the forward's bf16 copy is
    y cast to bf16, bit for bit, and a backward given both gradients equals
    one given their float32 sum, bit for bit."""
    from physics_informed_image_segmentation_tpu_torch.ops.group_norm import GroupNormAct

    site = (256, 65, 63, 32, 1e-6, True, True, False)
    x, weight, bias, r, dy, out = _gn_operands(site, torch.bfloat16, cuda, 2, seed=11)
    dy_low = torch.randn(x.shape, device=cuda).to(torch.bfloat16)
    ins = [t.clone().requires_grad_(True) for t in (x, weight, bias, r)]
    y, y_low = GroupNormAct.apply(*ins, 32, 1e-6, True, torch.float32, True, True)
    assert y_low.dtype == torch.bfloat16 and torch.equal(y_low, y.to(torch.bfloat16))
    both = torch.autograd.grad((y, y_low), ins, (dy, dy_low))
    _, summed = _gn_kernel(x, weight, bias, r, dy + dy_low.float(), 32, 1e-6, True, out)
    assert all(torch.equal(a, b) for a, b in zip(both, summed))


def test_group_norm_kernel_repeats_and_routes(cuda):
    """Same inputs, same bits (no atomics); a group all below 0 after the
    shift passes no gradient; ``group_norm_act`` takes bf16 and float32
    NCHW maps to the kernels and raises on a float64, channels-last or
    misaligned map: the card never falls back to PyTorch's GroupNorm."""
    from physics_informed_image_segmentation_tpu_torch.ops import group_norm as GN

    site = (256, 65, 63, 32, 1e-6, True, True, False)
    x, weight, bias, r, dy, out = _gn_operands(site, torch.bfloat16, cuda, 3, seed=9)
    first, second = (_gn_kernel(x, weight, bias, r, dy, 32, 1e-6, True, out) for _ in range(2))
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))
    bias[:8] = -50.0  # the first group's every pre-activation is far below 0
    y, grads = _gn_kernel(x, weight, bias, r, dy, 32, 1e-6, True, out)
    assert not bool(y[:, :8].gt(0).any()) and not bool(grads[3][:, :8].any())
    assert not bool(grads[0][:, :8].any()) and not bool(grads[1][:8].any())
    norm = torch.nn.GroupNorm(32, 256, eps=1e-6).to(cuda)
    for t in (x, x.float()):
        counts = {"fused": 0, "plain": 0}
        assert GN.group_norm_act(t, norm, counts, keep_dtype=True).dtype == t.dtype
        assert counts == {"fused": 1, "plain": 0}
    misaligned = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)[1:1 + x.numel()]
    for t, reason in ((x.double(), "type"),
                      (x.contiguous(memory_format=torch.channels_last), "NCHW-contiguous"),
                      (misaligned.view(x.shape).copy_(x), "16-byte aligned")):
        assert GN.kernel_refusals(t, norm.weight, norm.bias, None, t.dtype)
        with pytest.raises(ValueError, match=reason):
            GN.group_norm_act(t, norm, {"fused": 0, "plain": 0}, keep_dtype=True)


def test_group_norm_kernel_takes_an_offset_gradient(cuda):
    """Gradients that are contiguous views at an odd offset (not 16-byte
    aligned, where the kernels read in 16-byte vectors), for ``y`` and for
    its bf16 copy, give the same bits as the same values aligned."""
    from physics_informed_image_segmentation_tpu_torch.ops.group_norm import GroupNormAct

    def offset(t):
        view = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)[1:1 + t.numel()]
        view = view.view(t.shape).copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    site = (256, 65, 63, 32, 1e-6, True, True, False)
    x, weight, bias, r, dy, out = _gn_operands(site, torch.bfloat16, cuda, 2, seed=13)
    dy_low = torch.randn(x.shape, device=cuda).to(torch.bfloat16)
    got = []
    for grads in ((dy, dy_low), (offset(dy), offset(dy_low))):
        ins = [t.clone().requires_grad_(True) for t in (x, weight, bias, r)]
        y, y_low = GroupNormAct.apply(*ins, 32, 1e-6, True, torch.float32, True, True)
        got.append(torch.autograd.grad((y, y_low), ins, grads))
        got.append(_gn_kernel(x, weight, bias, r, grads[0], 32, 1e-6, True, out)[1])
    torch.cuda.synchronize()
    for a, b in zip(got[:2], got[2:]):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_transunet_resnet_norms_take_the_kernels(cuda):
    """A bf16 forward and backward of TransUNet at 1024² (batch 2): every
    one of the ResNet's 52 norms takes the kernels (52 fused calls a
    forward), PyTorch's GroupNorm never runs (no ``native_group_norm``, no
    ``RowwiseMomentsCUDAKernel``), and no float32 map is saved for the
    backward inside the ResNet.  Prints the ResNet's peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from physics_informed_image_segmentation_tpu_torch.models import TransUNet
    from physics_informed_image_segmentation_tpu_torch.ops import group_norm as GN

    size, b = 1024, 2
    model = TransUNet(img_size=size).to(cuda).train()
    g = torch.Generator(device=cuda).manual_seed(0)
    images = torch.rand(b, 1, size, size, device=cuda, generator=g)
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    def step(watch=False):
        model.norm_counts.update(fused=0, plain=0)
        with torch.autocast("cuda", torch.bfloat16):
            x = images.repeat(1, 3, 1, 1)
            if watch:
                with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                    feats, skips = model.transformer.embeddings.hybrid_model(x, model.norm_counts)
            else:
                feats, skips = model.transformer.embeddings.hybrid_model(x, model.norm_counts)
        loss = feats.float().square().mean() + sum(s.float().mean() for s in skips)
        torch.autograd.grad(loss, list(model.transformer.embeddings.hybrid_model.parameters()))

    step()
    GN.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(watch=True)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert model.norm_counts == {"fused": 52, "plain": 0}
    assert GN.launch_counts == {"group_norm_fwd": 52, "group_norm_bwd": 52}
    host = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    device = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert not [n for n in host if "group_norm" in n], host  # aten::group_norm, native_...
    # GroupNorm's statistics kernel (one type argument; LayerNorm's, which the
    # weight standardisation launches, has three)
    assert not [n for n in device if re.search(r"RowwiseMomentsCUDAKernel<[^,>]*>\(", n)]
    assert any("group_norm_fwd_apply" in n for n in device)
    # maps: (batch, C, H, W); the weights' standardisation saves float32 weights
    big_f32 = [shape for dtype, shape in saved
               if dtype == torch.float32 and len(shape) == 4 and shape[0] == b]
    print(json.dumps({"resnet_peak_gib": peak, "saved_float32_maps": big_f32}))
    assert not big_f32, big_f32


# ---- Swin-Unet's window attention (models/swin_unet.py) ----

FUSED_SDPA = ("aten::_scaled_dot_product_efficient_attention",
              "aten::_scaled_dot_product_cudnn_attention",
              "aten::_scaled_dot_product_flash_attention")


def _swin_block(seed=0):
    """A shifted Swin block of the first stage (width 96, 3 heads, window 7)
    on a 56² map, 64 windows, in float64 on the CPU: its weights torch's
    defaults under ``seed``, its bias table normal(0.5), wide enough that the
    bias moves the scores by more than bf16's rounding."""
    from physics_informed_image_segmentation_tpu_torch.models.swin_unet import (
        SwinTransformerBlock,
    )

    with torch.random.fork_rng():
        torch.manual_seed(seed)
        block = SwinTransformerBlock(96, 56, 3, 7, 3, 4.0, 0.0).double()
        with torch.no_grad():
            block.attn.relative_position_bias_table.normal_(0.0, 0.5)
    return block


def _swin_grads(block, x, cot, autocast=False):
    counts, windows = {"calls": 0, "pairs": 0}, {"windows": 0, "shifted": 0}
    with torch.autocast("cuda", torch.bfloat16, enabled=autocast):
        out = block(x, None, counts, windows)
    table = block.attn.relative_position_bias_table
    g_table, g_x = torch.autograd.grad(out, [table, x], cot.to(out.dtype))
    assert counts["calls"] == 1 and windows == {"windows": 2 * 64, "shifted": 1}
    return out.double().cpu(), g_table.double().cpu(), g_x.double().cpu()


def _rel(a, b):
    return float((a - b).norm() / b.norm())


# Relative gaps of the output, the table's gradient and the input's against
# float64.  float32: the kernels' own order of summation, 4.6e-7 at most
# measured (the table's gradient); bf16 autocast: q, k, v, the bias and dO
# rounded to 8 bits of mantissa, 6.5e-3 at most measured (the table's
# gradient, a sum over both images and 64 windows), 9e-4 the others
@pytest.mark.parametrize("autocast, tol", [(False, 1e-5), (True, 2e-2)], ids=["f32", "bf16"])
def test_swin_window_attention_runs_fused_and_learns_its_bias(cuda, autocast, tol):
    """A shifted Swin block's forward and backward on the card: the
    attention is one fused scaled-dot-product call (no math-backend call,
    no softmax of the CPU's plain path), and the output, the input's
    gradient and the bias table's gradient, which only the fused backward
    gives, match the plain path's in float64 on the CPU.  Prints the
    relative gaps and the attention's device kernels."""
    from torch.profiler import ProfilerActivity, profile

    block = _swin_block()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 56 * 56, 96, generator=g, dtype=torch.float64)
    cot = torch.randn(2, 56 * 56, 96, generator=g, dtype=torch.float64)
    ref = _swin_grads(block, x.clone().requires_grad_(), cot)
    card = block.float().to(cuda)
    xc = x.float().to(cuda).requires_grad_()
    _swin_grads(card, xc, cot.to(cuda), autocast)  # plans and workspaces
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = _swin_grads(card, xc, cot.to(cuda), autocast)
        torch.cuda.synchronize()
    ops = {e.name for e in prof.events()}
    fused = [n for n in FUSED_SDPA if n in ops]
    kernels = sorted({e.name[:80] for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and ("fmha" in e.name.lower() or "attention" in e.name.lower()
                           or "sdpa" in e.name.lower())})
    gaps = [_rel(a, b) for a, b in zip(got, ref)]
    print(json.dumps({"autocast": autocast, "fused": fused, "kernels": kernels,
                      "gaps_out_table_x": gaps}))
    assert len(fused) == 1 and "aten::_scaled_dot_product_attention_math" not in ops
    assert "aten::_softmax" not in ops
    assert float(got[1].norm()) > 0 and max(gaps) < tol, gaps


def test_swin_window_attention_has_no_math_fallback(cuda):
    """Where no fused backend takes the call (float64 on the card), the
    window attention raises instead of running the math backend's (windows,
    heads, N, N) scores.  (The whole block raises before it: its first
    LayerNorm's kernels take no float64.)"""
    block = _swin_block().to(cuda)
    x = torch.randn(2, 56 * 56, 96, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="type"):
        block(x, None, {"calls": 0, "pairs": 0}, {"windows": 0, "shifted": 0})
    windows = torch.randn(2 * 64, 49, 96, device=cuda, dtype=torch.float64)
    bias = block.attn.bias(block.attn_mask, 64, torch.float64)
    with pytest.raises(RuntimeError, match="kernel"):
        block.attn(windows, bias, 2, {"calls": 0, "pairs": 0})


# ---- LayerNorm (ops/layer_norm.py, csrc/layer_norm.cu) ----

def _swin_norm_sites(device, batch=8, size=896):
    """Every LayerNorm call of Swin-Unet at ``size``² under bf16 autocast,
    as ``(C, rows at batch, input type, output type)`` in call order:
    recorded from the model itself (a batch-1 no-grad forward)."""
    from physics_informed_image_segmentation_tpu_torch.models import SwinUnet
    from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

    sites, real = [], LN.LayerNormFn.apply

    def record(x, weight, bias, eps, out_dtype):
        sites.append((x.shape[-1], batch * (x.numel() // x.shape[-1]), x.dtype, out_dtype))
        return real(x, weight, bias, eps, out_dtype)

    model = SwinUnet(img_size=size).to(device).eval()
    LN.LayerNormFn.apply = record
    try:
        with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
            model(torch.rand(1, 1, size, size, device=device))
    finally:
        LN.LayerNormFn.apply = real
    return sites


def _ln_operands(c, rows, dtype, out, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    # a stream's rows differ in offset and scale
    x = (torch.randn(rows, c, device=device, generator=g)
         * (0.5 + torch.rand(rows, 1, device=device, generator=g))
         + torch.randn(rows, 1, device=device, generator=g)).to(dtype)
    weight = 1.0 + 0.2 * torch.randn(c, device=device, generator=g)
    bias = 0.1 * torch.randn(c, device=device, generator=g)
    dy = torch.randn(rows, c, device=device, generator=g).to(out)
    return x, weight, bias, dy


def _ln_kernel(x, weight, bias, dy, out):
    from physics_informed_image_segmentation_tpu_torch.ops.layer_norm import LayerNormFn

    ins = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    y = LayerNormFn.apply(*ins, 1e-5, out)
    return (y.detach(), *torch.autograd.grad(y, ins, dy))


def test_layer_norm_kernel_at_every_swin_site(cuda):
    """The kernels against their plain version on the card, in the sites'
    types, at the shape of each of the 38 norms of an 896² step, batch 8
    (13 distinct sites), forward and every gradient.  Tolerances: two
    float32 orders of the same sums, 1e-5 of the largest plus 1e-5
    relative, and one bf16 step (2^-7 relative) where a bf16 y or dx may
    round the other way."""
    from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

    sites = _swin_norm_sites(cuda)
    assert len(sites) == 38
    for i, (c, rows, dtype, out) in enumerate(dict.fromkeys(sites)):
        x, weight, bias, dy = _ln_operands(c, rows, dtype, out, cuda, seed=200 + i)
        got = _ln_kernel(x, weight, bias, dy, out)
        y, mean, rstd = LN.layer_norm_fwd_plain(x, weight, bias, 1e-5, out)
        want = (y, *LN.layer_norm_bwd_plain(dy, x, mean, rstd, weight))
        assert [t.dtype for t in got] == [t.dtype for t in want] == [out, dtype, torch.float32,
                                                                     torch.float32]
        for name, k, p in zip(("y", "dx", "dgamma", "dbeta"), got, want):
            rtol = 2.0 ** -7 if k.dtype == torch.bfloat16 else 1e-5
            ok, err = _gn_close(k, p.double(), rtol, 1e-5)
            assert ok, ((c, rows, dtype, out), name, err)
        del x, dy, got, want, y, mean, rstd
        torch.cuda.empty_cache()


def test_layer_norm_kernel_repeats_bit_for_bit(cuda):
    """Same inputs, same bits, the parameters' gradients too (no atomics),
    at the x4 expand's site (6.4 M rows of 96) and at the widest (1536)."""
    for c, rows, dtype, out in ((96, 8 * 896 * 896, torch.bfloat16, torch.bfloat16),
                                (1536, 8 * 28 * 28, torch.float32, torch.bfloat16)):
        x, weight, bias, dy = _ln_operands(c, rows, dtype, out, cuda, seed=c)
        first, second = (_ln_kernel(x, weight, bias, dy, out) for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        del x, dy, first, second


def test_layer_norm_kernel_raises_on_what_it_does_not_take(cuda):
    """float64, strided rows, a misaligned view, a width not built, bf16
    gamma: ``ValueError`` with the refusal's reason, never PyTorch's
    ``layer_norm``; a strided or misaligned gradient is made contiguous."""
    from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

    x, weight, bias, dy = _ln_operands(96, 64, torch.float32, torch.bfloat16, cuda, seed=3)
    misaligned = torch.empty(x.numel() + 8, device=cuda)[1:1 + x.numel()].view(x.shape)
    narrow = _ln_operands(48, 64, torch.float32, torch.bfloat16, cuda, seed=4)
    for args, reason in (((x.double(), weight, bias), "type"),
                         ((x.view(8, 8, 96).transpose(0, 1), weight, bias), "contiguous"),
                         ((misaligned.copy_(x), weight, bias), "16-byte aligned"),
                         (narrow[:3], "width"),
                         ((x, weight.bfloat16(), bias.bfloat16()), "gamma and beta")):
        assert LN.kernel_refusals(*args, torch.bfloat16)
        with pytest.raises(ValueError, match=reason):
            LN.LayerNormFn.apply(*args, 1e-5, torch.bfloat16)
    with pytest.raises(ValueError, match="type"):
        LN.LayerNormFn.apply(x, weight, bias, 1e-5, torch.float64)
    aligned = _ln_kernel(x, weight, bias, dy, torch.bfloat16)
    offset = torch.empty(dy.numel() + 8, dtype=dy.dtype, device=cuda)[1:1 + dy.numel()]
    shifted = _ln_kernel(x, weight, bias, offset.view(dy.shape).copy_(dy), torch.bfloat16)
    strided = _ln_kernel(x, weight, bias, dy.t().contiguous().t(), torch.bfloat16)
    for a, b, c in zip(aligned, shifted, strided):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_swin_unet_norms_take_the_kernels(cuda):
    """A bf16 forward and backward of Swin-Unet at 896² (batch 2): all 38
    norms take the kernels each way (38 and 38 launches), a no-grad forward
    38 and 0, and PyTorch's LayerNorm never runs (no ``native_layer_norm``
    host operation, no ``vectorized_layer_norm_kernel``).  Prints the
    step's peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from physics_informed_image_segmentation_tpu_torch.models import SwinUnet
    from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

    model = SwinUnet(img_size=896).to(cuda).train()
    images = torch.rand(2, 1, 896, 896, device=cuda, generator=torch.Generator(cuda).manual_seed(0))

    def step():
        with torch.autocast("cuda", torch.bfloat16):
            out = model(images, torch.Generator(cuda).manual_seed(1))
        torch.autograd.grad(out.mean(), list(model.parameters()))

    step()
    LN.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert LN.launch_counts == {"layer_norm_fwd": 38, "layer_norm_bwd": 38}
    host = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    device = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    assert not [n for n in host if "layer_norm" in n], host
    assert not [n for n in device if "vectorized_layer_norm" in n or "GammaBeta" in n]
    assert any("layer_norm_fwd<" in n for n in device)
    assert any("layer_norm_bwd_params" in n for n in device)
    LN.reset_launch_counts()
    with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
        model.eval()(images)
    assert LN.launch_counts == {"layer_norm_fwd": 38, "layer_norm_bwd": 0}
    print(json.dumps({"swinunet_896_b2_step_peak_gib": peak}))
