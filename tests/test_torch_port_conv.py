"""PyTorch port: the 3x3 SAME convolution's plain version, in both tap orders,
held against the JAX package's ``conv3x3_same`` on the same numpy inputs,
and the conv probe on the CPU.

The JAX side runs its Pallas kernels through the Pallas interpreter on the
CPU, as ``tests/test_pallas_conv.py`` does.  Tolerances are that file's
bars: forward rtol 1e-5 / atol 1e-5, loss rtol 1e-5, dx rtol 1e-4 / atol
1e-5, dw rtol 1e-4 / atol 1e-4; bf16 storage rtol 2e-2 / atol 2e-2.  The
CUDA kernels themselves are held against this plain version on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.ops.pallas_conv import (
    conv3x3_same as jax_conv3x3_same,
)
from physics_informed_image_segmentation_tpu_torch.ops import conv_kernel
from physics_informed_image_segmentation_tpu_torch.ops.conv_kernel import (
    conv3x3_same,
    conv3x3_same_reference,
)
from physics_informed_image_segmentation_tpu_torch.utils import conv_probe


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(b=2, h=16, w=16, cin=8, cout=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 8), (1, 8, 32, 4, 12), (2, 12, 8, 12, 4)])
def test_forward_matches_jax(paired, shape):
    x, wt = _data(*shape)
    ours = conv3x3_same(torch.tensor(x), torch.tensor(wt), paired)
    ref = jax_conv3x3_same(jnp.asarray(x), jnp.asarray(wt), paired)
    assert ours.shape == shape[:3] + shape[4:] and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 8), (1, 8, 32, 4, 12)])
def test_vjp_matches_jax(paired, shape):
    x, wt = _data(*shape, seed=1)

    def f_jax(x, w):
        return jnp.sum(jax_conv3x3_same(x, w, paired) ** 2)

    lr, (dxr, dwr) = jax.value_and_grad(f_jax, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wt))
    xt, wtt = torch.tensor(x, requires_grad=True), torch.tensor(wt, requires_grad=True)
    lo = (conv3x3_same(xt, wtt, paired) ** 2).sum()
    dxo, dwo = torch.autograd.grad(lo, (xt, wtt))
    np.testing.assert_allclose(float(lo), float(lr), rtol=1e-5)
    np.testing.assert_allclose(dxo.numpy(), np.asarray(dxr), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dwo.numpy(), np.asarray(dwr), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("paired", [False, True])
def test_bf16_storage_f32_accum(paired):
    x, wt = _data(seed=2)
    xb, wb = torch.tensor(x).to(torch.bfloat16), torch.tensor(wt).to(torch.bfloat16)
    ours = conv3x3_same(xb, wb, paired)
    # the same bf16 values on the JAX side
    ref = jax_conv3x3_same(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                           jnp.asarray(wb.float().numpy()).astype(jnp.bfloat16), paired)
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)
    # float32 weights are cast to x's type, and their gradient comes back float32
    wf = torch.tensor(wt, requires_grad=True)
    out = conv3x3_same(xb, wf, paired)
    (dw,) = torch.autograd.grad(out.float().sum(), wf)
    assert out.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert torch.equal(out, ours)


# Channel counts that the wgmma kernels take on the card (Cin 64 or 128, Cout a
# multiple of 64), small in space: the plain version that those kernels are held
# to, in both tap orders, against the JAX kernel.
WGMMA_SHAPES = [(1, 8, 16, 64, 64), (1, 16, 8, 128, 64), (1, 8, 16, 64, 128)]


def _cotangent(shape, seed):
    b, h, w, _, cout = shape
    return (np.random.default_rng(seed).standard_normal((b, h, w, cout)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_plain_version_matches_jax_at_the_wgmma_channel_counts(paired, shape):
    x, wt = _data(*shape, seed=4)
    cot = _cotangent(shape, seed=5)
    ref, vjp = jax.vjp(lambda a, b: jax_conv3x3_same(a, b, paired), jnp.asarray(x), jnp.asarray(wt))
    dxr, dwr = vjp(jnp.asarray(cot))
    xt, wtt = torch.tensor(x, requires_grad=True), torch.tensor(wt, requires_grad=True)
    ours = conv3x3_same_reference(xt, wtt, paired)
    dxo, dwo = torch.autograd.grad(ours, (xt, wtt), torch.tensor(cot))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dxo.numpy(), np.asarray(dxr), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dwo.numpy(), np.asarray(dwr), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_plain_version_matches_jax_in_bf16_at_the_wgmma_channel_counts(paired, shape):
    x, wt = _data(*shape, seed=6)
    bf = torch.bfloat16
    xb, wb, cb = (torch.tensor(a).to(bf) for a in (x, wt, _cotangent(shape, seed=7)))
    # the same bf16 values on the JAX side
    as_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    ref, vjp = jax.vjp(lambda a, b: jax_conv3x3_same(a, b, paired), as_jax(xb), as_jax(wb))
    dxr, dwr = vjp(as_jax(cb))
    xt, wtt = xb.clone().requires_grad_(True), wb.clone().requires_grad_(True)
    ours = conv3x3_same_reference(xt, wtt, paired)
    dxo, dwo = torch.autograd.grad(ours, (xt, wtt), cb)
    assert ours.dtype == dxo.dtype == dwo.dtype == bf
    for got, want in ((ours.detach(), ref), (dxo, dxr), (dwo, dwr)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("paired", [False, True])
def test_border_zero_padding(paired):
    """An all-ones input: border sums must reflect zero padding exactly."""
    out = conv3x3_same(torch.ones((1, 8, 16, 4)), torch.ones((3, 3, 4, 4)), paired).numpy()
    assert np.all(out[0, 4, 8] == 9 * 4)     # interior: all 9 taps
    assert np.all(out[0, 0, 8] == 6 * 4)     # top edge: 6 taps
    assert np.all(out[0, 0, 0] == 4 * 4)     # corner: 4 taps
    assert np.all(out[0, 7, 15] == 4 * 4)


def test_tap_orders_sum_the_same_products():
    x, wt = _data(seed=3)
    a = conv3x3_same_reference(torch.tensor(x), torch.tensor(wt), False)
    b = conv3x3_same_reference(torch.tensor(x), torch.tensor(wt), True)
    assert not torch.equal(a, b)  # another order of float32 summation
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_rejects_a_width_that_is_not_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two W"):
        conv3x3_same(torch.ones((1, 8, 24, 4)), torch.ones((3, 3, 4, 4)))
    with pytest.raises(ValueError, match="power-of-two W"):
        jax_conv3x3_same(jnp.ones((1, 8, 24, 4)), jnp.ones((3, 3, 4, 4)))
    # the plain version itself (as the CUDA kernel) takes any width
    assert conv3x3_same_reference(torch.ones((1, 8, 24, 4)),
                                  torch.ones((3, 3, 4, 4))).shape == (1, 8, 24, 4)


def test_cpu_tensors_launch_no_kernel():
    conv_kernel.reset_launch_counts()
    conv3x3_same(torch.ones((1, 4, 4, 4)), torch.ones((3, 3, 4, 4)))
    assert conv_kernel.launch_counts == {
        "conv3x3_fwd": 0, "conv3x3_fwd_paired": 0, "conv3x3_dw": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv_kernel.Conv3x3Same.apply(torch.ones((1, 4, 4, 4)), torch.ones((3, 3, 4, 4)), False)


def test_probe_flops_are_the_jax_probes():
    # scripts/conv_probe.py: FWD_FLOPS = 2 * BATCH * SIZE * SIZE * 9 * C * C
    assert conv_probe.fwd_flops(8, 128, 64) == 2 * 8 * 128 * 128 * 9 * 64 * 64
    assert (conv_probe.BATCH, conv_probe.SIZE, conv_probe.CHANNELS) == (8, 128, 64)
    assert (conv_probe.WARMUP, conv_probe.TIMED) == (2, 5)


def test_probe_on_the_cpu_prints_its_rows(capsys, tmp_path):
    out = tmp_path / "sub" / "probe.json"
    assert conv_probe.main(["--device", "cpu", "--steps", "2", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    for name in ("cudnn", "cuda", "cuda-paired"):
        for label in ("fwd", "fwdbwd"):
            (line,) = [ln for ln in text.splitlines() if ln.split()[:2] == [name, label]]
            assert "us/step" in line and "TF/s" in line and line.endswith("]")
    assert "cuda vs cudnn (fwd):" in text and "cuda-paired vs cudnn (fwdbwd):" in text
    import json

    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["shape"] == [2, 16, 16, 8] and res["steps"] == 2
    assert set(res["results"]) == {"cudnn", "cuda", "cuda-paired"}
    assert all(cell["us_per_step"] > 0 for row in res["results"].values() for cell in row.values())


def test_probe_one_implementation_and_no_file(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert conv_probe.main(["cuda-paired", "--device", "cpu", "--steps", "1"]) == 0
    text = capsys.readouterr().out
    assert "cuda-paired  fwd" in text and "cudnn" not in text and " vs " not in text
    assert list(tmp_path.iterdir()) == []  # it writes a file only when --out is given


def test_probe_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        conv_probe.run_probe(steps=1)
