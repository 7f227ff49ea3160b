"""PyTorch port: GroupNorm with its residual add and ReLU (``ops/group_norm.py``).

* The autograd Function's plain version (the CUDA kernels' arithmetic:
  statistics summed in float64, the backward's per-channel sums and
  per-group means, the ReLU's mask kept only where a residual meets it and
  recomputed elsewhere) against ``nn.GroupNorm``, the add and ``F.relu``
  under autograd in float64, forward and every gradient, at each kind of
  norm site of TransUNet's ResNetV2;
* ``TransUNet.norm_counts``: 52 plain calls a forward on the CPU;
* the routing: what the kernels would take (only the device keeps a bf16
  or float32 NCHW CPU map from them) and what they refuse (on the card
  they raise for it), and ``group_norm_act`` on the CPU being the plain
  version, the model's one CPU path.

The kernels themselves run only on the card (``test_torch_port_cuda.py``).
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from physics_informed_image_segmentation_tpu_torch.models import TransUNet
from physics_informed_image_segmentation_tpu_torch.ops import group_norm as GN

# float64 against float64: two orders of the same sums
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# label: (N, C, H, W), groups, eps, residual, relu, the bias of the first group
SITES = {
    "gn1/gn2": ((2, 64, 9, 9), 32, 1e-6, False, True, None),
    "gn3 with the residual": ((2, 128, 8, 8), 32, 1e-6, True, True, None),
    "gn_proj: one channel a group, eps 1e-5": ((2, 64, 5, 5), 64, 1e-5, False, False, None),
    "root": ((1, 64, 16, 16), 32, 1e-6, False, True, None),
    "a group all below 0 after the shift": ((2, 64, 6, 6), 32, 1e-6, True, True, -50.0),
    "odd H*W": ((3, 32, 7, 5), 8, 1e-6, False, True, None),
}


def _operands(shape, residual, first_bias, seed):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 1.5 + 0.3
    weight = 1.0 + 0.2 * torch.randn(c, generator=g, dtype=torch.float64)
    bias = 0.1 * torch.randn(c, generator=g, dtype=torch.float64)
    if first_bias is not None:
        bias[: c // 32 or 1] = first_bias
    r = torch.randn(shape, generator=g, dtype=torch.float64) if residual else None
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    return x, weight, bias, r, dy


def _grads(fn, x, weight, bias, r, dy):
    ins = [t.clone().requires_grad_(True) for t in (x, weight, bias) + ((r,) if r is not None
                                                                         else ())]
    y = fn(*ins[:3], ins[3] if r is not None else None)
    return (y.detach(), *torch.autograd.grad(y, ins, dy))


@pytest.mark.parametrize("site", list(SITES), ids=list(SITES))
def test_plain_version_matches_group_norm_add_and_relu(site):
    shape, groups, eps, residual, relu, first_bias = SITES[site]
    x, weight, bias, r, dy = _operands(shape, residual, first_bias, seed=len(site))

    def function(x, w, b, r):
        return GN.GroupNormAct.apply(x, w, b, r, groups, eps, relu, torch.float64, True)

    def modules(x, w, b, r):
        y = F.group_norm(x, groups, w, b, eps)
        if r is not None:
            y = r + y
        return F.relu(y) if relu else y

    got, want = _grads(function, x, weight, bias, r, dy), _grads(modules, x, weight, bias, r, dy)
    assert len(got) == len(want) == (5 if residual else 4)
    for name, a, b in zip(("y", "dx", "dgamma", "dbeta", "dr"), got, want):
        assert a.dtype == torch.float64 and a.shape == b.shape, name
        assert float((a - b).abs().max()) <= TOL * max(1.0, float(b.abs().max())), name
    if first_bias is not None:
        k = shape[1] // groups
        assert not bool(got[0][:, :k].any()) and not bool(got[1][:, :k].any())
        assert not bool(got[2][:k].any()) and not bool(got[4][:, :k].any())


def test_plain_version_of_the_bf16_copy():
    """With ``low_copy`` the Function also returns y cast to bf16, and its
    gradient adds to y's: as autograd of ``(y, y.to(bf16))`` would."""
    shape, groups, eps, residual, relu, _ = SITES["gn3 with the residual"]
    x, weight, bias, r, dy = _operands(shape, residual, None, seed=5)
    dy_low = torch.randn(shape, generator=torch.Generator().manual_seed(6)).to(torch.bfloat16)
    ins = [t.clone().requires_grad_(True) for t in (x, weight, bias, r)]
    y, y_low = GN.GroupNormAct.apply(*ins, groups, eps, relu, torch.float64, True, True)
    assert torch.equal(y_low, y.to(torch.bfloat16))
    got = torch.autograd.grad((y, y_low), ins, (dy, dy_low))
    ref_ins = [t.clone().requires_grad_(True) for t in (x, weight, bias, r)]
    ref = F.relu(ref_ins[3] + F.group_norm(ref_ins[0], groups, ref_ins[1], ref_ins[2], eps))
    want = torch.autograd.grad((ref, ref.to(torch.bfloat16)), ref_ins, (dy, dy_low))
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= TOL * max(1.0, float(b.abs().max()))


def test_plain_version_keeps_the_mask_only_where_a_residual_meets_the_relu():
    """Saved for the backward: the input itself, float32 statistics a
    (sample, group) for a float32 input, and a mask only with a residual;
    without one the backward recomputes the ReLU's decisions."""
    x, weight, bias, r, dy = (t.float() if t is not None else None
                              for t in _operands((2, 64, 6, 6), True, None, seed=3))
    for residual in (None, r):
        y, low, mean, rstd, mask = GN.group_norm_act_fwd_plain(x, weight, bias, residual, 32,
                                                               1e-6, True, torch.float32, True)
        assert mean.shape == rstd.shape == (2, 32) and mean.dtype == torch.float32
        assert (mask is not None) is (residual is not None)
        dx, dgamma, dbeta, dr = GN.group_norm_act_bwd_plain(
            dy, None, x, mask, mean, rstd, weight, bias, 32, True, residual is not None)
        assert (dr is not None) is (residual is not None)
        assert dx.dtype == torch.float32 and dgamma.shape == dbeta.shape == (64,)
    _, low, _, _, none = GN.group_norm_act_fwd_plain(x, weight, bias, r, 32, 1e-6, True,
                                                     torch.float32, False)
    assert none is None and low is None  # nothing kept for a backward under no_grad


def test_a_transunet_forward_makes_52_plain_norm_calls():
    model = TransUNet(img_size=224).eval()
    with torch.no_grad():
        model(torch.rand(1, 1, 224, 224))
    assert model.norm_counts == {"fused": 0, "plain": 52}
    with torch.no_grad():
        model(torch.rand(1, 1, 224, 224))
    assert model.norm_counts == {"fused": 0, "plain": 104}


@pytest.mark.parametrize("dtype, layout, keep, expected", [
    (torch.bfloat16, "nchw", True, ["device cpu"]),
    (torch.bfloat16, "nchw", False, ["device cpu"]),
    (torch.float32, "nchw", False, ["device cpu"]),
    (torch.float64, "nchw", False, ["device cpu", "type"]),
    (torch.float32, "nhwc", False, ["device cpu", "not an NCHW-contiguous map"]),
    (torch.bfloat16, "misaligned", True, ["device cpu", "not 16-byte aligned"]),
])
def test_routing_follows_the_operands(dtype, layout, keep, expected):
    """A CPU map is refused for its device alone where it is bf16 or
    float32 and NCHW-contiguous, so on the card it takes the kernels;
    float64, channels-last and a misaligned map are refused for more, and
    on the card make ``group_norm_act`` raise."""
    norm = nn.GroupNorm(32, 64, eps=1e-6)
    x = torch.randn(2, 64, 9, 9).to(dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "misaligned":
        x = torch.empty(x.numel() + 8, dtype=dtype)[1:1 + x.numel()].view(x.shape).copy_(x)
    out = dtype if keep else torch.promote_types(dtype, torch.float32)
    why = GN.kernel_refusals(x, norm.weight, norm.bias, None, out)
    assert [w.split(" ")[0] if w.startswith("type") else w for w in why] == expected, why


def test_residual_and_parameters_route_too():
    norm = nn.GroupNorm(32, 64, eps=1e-6)
    x = torch.randn(2, 64, 9, 9, dtype=torch.bfloat16)
    assert GN.kernel_refusals(x, norm.weight, norm.bias, torch.randn(2, 64, 9, 9),
                              torch.float32) == ["device cpu"]
    for residual in (torch.randn(2, 64, 9, 9, dtype=torch.bfloat16), torch.randn(2, 64, 9, 8),
                     torch.randn(2, 64, 9, 9).contiguous(memory_format=torch.channels_last)):
        assert GN.kernel_refusals(x, norm.weight, norm.bias, residual, torch.float32)[1:] == [
            "residual not a float32 map of x's shape and layout"]
    half = nn.GroupNorm(32, 64).to(torch.bfloat16)
    assert "gamma and beta not float32" in GN.kernel_refusals(x, half.weight, half.bias, None,
                                                              torch.float32)


@pytest.mark.parametrize("residual, relu", [(False, True), (True, True), (False, False)])
def test_plain_path_is_the_sites_own_code(residual, relu):
    """On the CPU ``group_norm_act`` is the Function's plain version, bit
    for bit, which is the site's ``norm(x)``, ``residual + y`` and
    ``F.relu`` up to float32 rounding (the statistics summed in float64),
    and counts one plain call."""
    norm = nn.GroupNorm(32, 64, eps=1e-6)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.2)
        norm.bias.normal_(0.0, 0.1)
    x, r = torch.randn(2, 64, 7, 7), torch.randn(2, 64, 7, 7) if residual else None
    counts = {"fused": 0, "plain": 0}
    got = GN.group_norm_act(x, norm, counts, residual=r, relu=relu)
    assert counts == {"fused": 0, "plain": 1}
    plain = GN.group_norm_act_fwd_plain(x, norm.weight, norm.bias, r, 32, 1e-6, relu,
                                        torch.float32, True)[0]
    assert got.dtype == torch.float32 and torch.equal(got, plain)
    want = norm(x)
    if residual:
        want = r + want
    want = F.relu(want) if relu else want
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
