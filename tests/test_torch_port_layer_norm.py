"""PyTorch port: LayerNorm with its output in its site's type (``ops/layer_norm.py``).

* The autograd Function's plain version (the CUDA kernels' arithmetic:
  float32 statistics per row, the backward's two row means and the
  parameters' column sums) against autograd of ``nn.LayerNorm`` in
  float64, forward and every gradient, at each width of Swin-Unet's sites
  and each pair of input and output types they use, and in float64 itself;
* the output type of each role, and of each of Swin-Unet's 38 norms under
  bf16 autocast (float32 where the output joins the stream, bf16 where
  only a linear or the output convolution reads it);
* the routing: what the kernels would take (only the device keeps a bf16
  or float32 CPU row of a built width from them) and what they refuse (on
  the card they raise for it).

The kernels themselves run only on the card (``test_torch_port_cuda.py``).
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from physics_informed_image_segmentation_tpu_torch.models import SwinUnet
from physics_informed_image_segmentation_tpu_torch.ops import layer_norm as LN

F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
# input and output types of the model's sites under bf16 autocast: the
# stream into a linear, a bf16 linear's output into the stream, the x4
# expand's bf16 output into the output convolution; and float64 throughout
PAIRS = [(F32, BF16), (BF16, F32), (BF16, BF16), (F64, F64)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _operands(rows, c, x_dtype, out_dtype, seed):
    """x with a per-row offset and scale (a stream's rows differ), gamma
    and beta away from 1 and 0, and dy in the output's type."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(rows, c, generator=g, dtype=F64) * (0.5 + torch.rand(rows, 1, generator=g,
                                                                         dtype=F64))
         + torch.randn(rows, 1, generator=g, dtype=F64)).to(x_dtype)
    weight = (1.0 + 0.2 * torch.randn(c, generator=g, dtype=F64)).to(
        F64 if x_dtype == F64 else F32)
    bias = (0.1 * torch.randn(c, generator=g, dtype=F64)).to(weight.dtype)
    dy = torch.randn(rows, c, generator=g, dtype=F64).to(out_dtype)
    return x, weight, bias, dy


def _close(got, want, rtol, atol_rel):
    err = (got.double() - want).abs()
    return bool(torch.all(err <= atol_rel * want.abs().max() + rtol * want.abs())), float(err.max())


@pytest.mark.parametrize("c", LN.WIDTHS)
@pytest.mark.parametrize("x_dtype, out_dtype", PAIRS, ids=["f32-bf16", "bf16-f32", "bf16-bf16",
                                                          "f64-f64"])
def test_plain_version_matches_layer_norm(c, x_dtype, out_dtype):
    """y, dx, dgamma and dbeta of the plain version against autograd of
    ``F.layer_norm`` in float64 on the same (rounded) x and dy.
    Tolerances: float64 against float64, 1e-12 of the largest; otherwise
    the float32 arithmetic, 1e-5 of the largest plus 1e-5 relative, and one
    bf16 rounding (2^-8 relative) for a bf16 y or dx."""
    x, weight, bias, dy = _operands(64, c, x_dtype, out_dtype, seed=c)
    ins = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
    y = LN.LayerNormFn.apply(*ins, 1e-5, out_dtype)
    got = (y.detach(), *torch.autograd.grad(y, ins, dy))
    assert [t.dtype for t in got] == [out_dtype, x_dtype, weight.dtype, bias.dtype]
    ref_ins = [t.double().requires_grad_(True) for t in (x, weight, bias)]
    z = F.layer_norm(ref_ins[0], (c,), ref_ins[1], ref_ins[2], 1e-5)
    want = (z.detach(), *torch.autograd.grad(z, ref_ins, dy.double()))
    for name, k, p, dtype in zip(("y", "dx", "dgamma", "dbeta"), got, want,
                                 (out_dtype, x_dtype, F32, F32)):
        if x_dtype == F64:
            ok, err = _close(k, p, 0.0, 1e-12)
        else:
            ok, err = _close(k, p, 2.0 ** -8 if dtype == BF16 else 1e-5, 1e-5)
        assert ok, (name, err)


def test_plain_statistics_are_float32_per_row():
    """mean and rstd: one float32 each a row, from a (2, 3, C) input."""
    x = torch.randn(2, 3, 96, dtype=BF16)
    y, mean, rstd = LN.layer_norm_fwd_plain(x, torch.ones(96), torch.zeros(96), 1e-5, F32)
    assert y.shape == x.shape and y.dtype == F32
    assert mean.shape == rstd.shape == (6,) and mean.dtype == rstd.dtype == F32
    torch.testing.assert_close(mean, x.float().reshape(6, 96).mean(-1))


def test_roles_give_the_output_type():
    x32, x16 = torch.randn(2, 96), torch.randn(2, 96).to(BF16)
    assert LN.output_dtype(x16, "stream") == F32 and LN.output_dtype(x32, "stream") == F32
    assert LN.output_dtype(x32, "compute") == F32 and LN.output_dtype(x16, "compute") == BF16
    with torch.autocast("cpu", BF16):
        assert LN.output_dtype(x32, "compute") == BF16
        assert LN.output_dtype(x32, "stream") == F32
    assert LN.output_dtype(x32.double(), "stream") == F64
    with pytest.raises(ValueError, match="out must be one of"):
        LN.LayerNorm(96, out="bf16")
    norm = LN.LayerNorm(96, out="compute")
    assert list(norm.state_dict()) == ["weight", "bias"] and norm.eps == 1e-5
    assert torch.equal(norm.weight, torch.ones(96)) and torch.equal(norm.bias, torch.zeros(96))


def test_swin_unet_norms_write_their_sites_types():
    """Under bf16 autocast (CPU, small widths), each of the 38 norms reads
    its input in its own type and writes float32 where the output becomes
    the stream (the patch embedding's, the three PatchExpand ones), bf16
    where only a linear or the output convolution reads it."""
    model = SwinUnet(img_size=224, embed_dim=24, num_heads=(1, 2, 4, 8))
    seen = {}

    def hook(name):
        def record(module, args, out):
            seen[name] = (args[0].dtype, out.dtype)
        return record

    norms = {n: m for n, m in model.named_modules() if isinstance(m, nn.LayerNorm)}
    assert len(norms) == 38 and all(isinstance(m, LN.LayerNorm) for m in norms.values())
    for name, m in norms.items():
        m.register_forward_hook(hook(name))
    with torch.no_grad(), torch.autocast("cpu", BF16):
        model(torch.rand(1, 1, 224, 224))
    stream = {"swin_unet.patch_embed.norm", "swin_unet.layers_up.0.norm",
              "swin_unet.layers_up.1.upsample.norm", "swin_unet.layers_up.2.upsample.norm"}
    assert {n for n, m in norms.items() if m.out == "stream"} == stream
    want = {n: ((BF16, F32) if n in stream else (F32, BF16)) for n in norms}
    want["swin_unet.up.norm"] = (BF16, BF16)
    assert seen == want


@pytest.mark.parametrize("case, expected", [
    ("bf16", ["device cpu"]),
    ("float32", ["device cpu"]),
    ("float64", ["device cpu", "type"]),
    ("to float64", ["device cpu", "type"]),
    ("width 48", ["device cpu", "width"]),
    ("strided rows", ["device cpu", "rows not contiguous"]),
    ("misaligned", ["device cpu", "not 16-byte aligned"]),
    ("bf16 gamma", ["device cpu", "gamma and beta not 16-byte aligned float32 of the row's width"]),
])
def test_routing_follows_the_operands(case, expected):
    """A CPU row is refused for its device alone where it is bf16 or
    float32, contiguous, aligned and of a built width, so on the card it
    takes the kernels; every other case is refused for more, and on the
    card makes ``LayerNormFn`` raise."""
    c = 48 if case == "width 48" else 96
    norm = nn.LayerNorm(c)
    x = torch.randn(4, 5, c).to(F64 if case == "float64" else BF16 if case == "bf16" else F32)
    out = F64 if case == "to float64" else BF16
    if case == "strided rows":
        x = torch.randn(5, 4, c).transpose(0, 1)
    elif case == "misaligned":
        x = torch.empty(x.numel() + 8)[1:1 + x.numel()].view(x.shape).copy_(x)
    weight, bias = norm.weight, norm.bias
    if case == "bf16 gamma":
        weight, bias = weight.to(BF16), bias.to(BF16)
    why = LN.kernel_refusals(x, weight, bias, out)
    assert [w.split(" ")[0] if w.startswith(("type", "width")) else w for w in why] == expected
