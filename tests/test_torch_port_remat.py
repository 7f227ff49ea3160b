"""PyTorch port: ``UNet(remat=True)``, the counterpart of the JAX U-Net's
``nn.remat(DoubleConv)``.

* Against ``remat=False`` on the CPU in float32, training with dropout 0.2
  from a seeded generator: the forward, the input's and every parameter's
  gradient are bit-equal, and the generator ends in the same state.  A
  recompute that drew its dropout masks again would draw other masks and
  change the gradients; one that drew them from the generator would move
  it on.
* Against the JAX ``UNet(remat=True)`` at base 4, 32x32, dropout 0:
  forward atol 2e-6 and gradients within tests/test_torch_port_unet.py's
  bar (rtol 1e-4 + atol 1e-6·max|g|), the port's gradient pass on
  PyTorch's own CPU convolutions and JAX's in float64, as there.
* The ``state_dict`` keys do not change.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.models import UNet as JaxUNet
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _train_pass(remat, activation, generator=True):
    model = UNet(base_channels=4, dropout=0.2, intermediate_activation=activation, remat=remat,
                 generator=torch.Generator().manual_seed(0)).train()
    gen = torch.Generator().manual_seed(7) if generator else None
    if not generator:
        torch.manual_seed(7)
    x = torch.rand((3, 1, 32, 32), generator=torch.Generator().manual_seed(1),
                   requires_grad=True)
    w = torch.randn((3, 1, 32, 32), generator=torch.Generator().manual_seed(2))
    out = model(x, gen)
    (out * w).sum().backward()
    state = (gen if generator else torch.default_generator).get_state()
    return out.detach(), x.grad, [p.grad for p in model.parameters()], state


@pytest.mark.parametrize("activation,generator", [
    ("relu", True), ("prelu", True), ("relu", False),
])
def test_remat_is_bit_equal_with_dropout(activation, generator):
    plain = _train_pass(False, activation, generator)
    remat = _train_pass(True, activation, generator)
    assert torch.equal(plain[0], remat[0])
    assert torch.equal(plain[1], remat[1])
    assert len(plain[2]) == len(remat[2])
    for a, b in zip(plain[2], remat[2]):
        assert torch.equal(a, b)
    assert torch.equal(plain[3], remat[3])


def test_remat_in_eval_and_without_grad_is_the_plain_forward():
    x = torch.rand((2, 1, 32, 32), generator=torch.Generator().manual_seed(3))
    a = UNet(base_channels=4, generator=torch.Generator().manual_seed(0)).eval()
    b = UNet(base_channels=4, remat=True, generator=torch.Generator().manual_seed(0)).eval()
    assert torch.equal(a(x), b(x))
    with torch.no_grad():
        g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
        assert torch.equal(a.train()(x, g1), b.train()(x, g2))


def test_state_dict_keys_unchanged():
    a, b = UNet(base_channels=4), UNet(base_channels=4, remat=True)
    assert list(a.state_dict()) == list(b.state_dict())
    for (na, ta), (nb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ta.shape == tb.shape
    b.load_state_dict(a.state_dict())


def _close_grad(ours, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        ours, ref, rtol=1e-4, atol=1e-6 * float(np.abs(ref).max()) + 1e-12, err_msg=name)


def test_remat_matches_jax_remat():
    c, hw = 4, 32
    jmodel = JaxUNet(base_channels=c, dropout=0.0, remat=True, dtype=jnp.float32)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, hw, hw, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = UNet(base_channels=c, dropout=0.0, remat=True).train()
    model.load_state_dict(state_dict_from_jax(params, dropout=0.0))
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, hw, hw, 1)).astype(np.float32)
    w = rng.normal(size=(2, hw, hw, 1)).astype(np.float32)

    ref_out = np.asarray(jmodel.apply(params, jnp.asarray(x), deterministic=False))

    def jax_obj(p, xx, ww):
        out = jmodel.clone(dtype=jnp.float64).apply(p, xx, deterministic=False)
        return jnp.sum(out * ww)

    with jax.enable_x64(True):
        ref_gp, ref_gx = jax.grad(jax_obj, (0, 1))(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params),
            jnp.asarray(x, jnp.float64), jnp.asarray(w, jnp.float64))
        ref_gp, ref_gx = jax.tree_util.tree_map(np.asarray, (ref_gp, ref_gx))

    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    with torch.backends.mkldnn.flags(enabled=False):
        out = model(xt)
        (out * torch.tensor(w.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), ref_out, atol=2e-6)
    _close_grad(xt.grad.numpy().transpose(0, 2, 3, 1), ref_gx, "input")
    ref_grads = state_dict_from_jax(ref_gp, dropout=0.0)
    for name, p in model.named_parameters():
        _close_grad(p.grad.numpy(), ref_grads[name].numpy(), name)
