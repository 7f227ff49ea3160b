"""PyTorch port: U-Net and the JAX-weights import, held against the JAX U-Net.

Weights come from the JAX model's init and are carried over by
``state_dict_from_jax``; the same numpy input goes through both models.
Forward tolerance, both in float32: 2e-6 absolute, the bar of
tests/test_torch_interop.py.  Gradients: rtol 1e-4 plus atol 1e-6·max|g| per
tensor, because conv weight gradients are float32 sums of B·H·W products.

The tests run on one intra-op thread.  There float32 resolves some gradient
elements, sums whose terms cancel, only to a few 1e-6 against the bar's
1e-6·max|g|, on both sides: JAX's float32 ``enc1.conv.0.bias`` with PReLU
is 3.3e-6 from the float64 gradient at one element, and oneDNN's reductions
miss the float64 gradient at one to three elements per case (``up1.bias``
with ReLU; ``enc1.conv.0.bias``, ``enc1.conv.2.weight`` (6.7e-6) and
``enc1.conv.2.bias`` with PReLU).  So the gradients are held against JAX's
gradient taken in float64 (its U-Net casts the logits to float32 before the
output activation; that costs at most 0.15 of the bar against a gradient
that is float64 throughout), and the port's gradient pass runs on PyTorch's
own CPU convolutions, which meet the bar everywhere.  That is a condition
of the test, not of the port: on the CPU the port runs the convolutions
PyTorch picks, and its forward pass on them is held against JAX as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.models import UNet as JaxUNet
from physics_informed_image_segmentation_tpu.utils.torch_interop import export_torch_state_dict
from physics_informed_image_segmentation_tpu_torch.models import UNet, count_parameters
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_model_and_params(hw, **kw):
    model = JaxUNet(dtype=jnp.float32, **kw)
    params = model.init(jax.random.key(0), jnp.zeros((1, hw, hw, 1), jnp.float32))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(params, **kw):
    model = UNet(**kw)
    model.load_state_dict(state_dict_from_jax(params, dropout=kw.get("dropout", 0.2)))
    return model


def _close_grad(ours, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        ours, ref, rtol=1e-4, atol=1e-6 * float(np.abs(ref).max()) + 1e-12, err_msg=name
    )


@pytest.mark.parametrize("decoder,activation", [
    ("concat", "relu"), ("split", "relu"), ("concat", "prelu"),
])
def test_forward_and_gradients_match_jax(decoder, activation):
    c, hw = 8, 32
    jmodel, params = _jax_model_and_params(
        hw, base_channels=c, dropout=0.0, decoder=decoder, intermediate_activation=activation)
    model = _port(params, base_channels=c, dropout=0.0, intermediate_activation=activation)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, hw, hw, 1)).astype(np.float32)
    w = rng.normal(size=(2, hw, hw, 1)).astype(np.float32)

    ref_out = jmodel.apply(params, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        out = model(torch.tensor(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref_out), atol=2e-6)

    def jax_obj(p, xx, ww):
        return jnp.sum(jmodel.clone(dtype=jnp.float64).apply(p, xx, deterministic=True) * ww)

    with jax.enable_x64(True):
        ref_gp, ref_gx = jax.grad(jax_obj, (0, 1))(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params),
            jnp.asarray(x, jnp.float64), jnp.asarray(w, jnp.float64))
        ref_gp, ref_gx = jax.tree_util.tree_map(np.asarray, (ref_gp, ref_gx))

    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    with torch.backends.mkldnn.flags(enabled=False):
        out = model(xt)
        (out * torch.tensor(w.transpose(0, 3, 1, 2))).sum().backward()
    np.testing.assert_allclose(
        out.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref_out), atol=2e-6)
    _close_grad(xt.grad.numpy().transpose(0, 2, 3, 1), ref_gx, "input")

    ref_grads = state_dict_from_jax(ref_gp, dropout=0.0)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) <= set(ref_grads)
    for name, g in grads.items():
        _close_grad(g.numpy(), ref_grads[name].numpy(), name)


@pytest.mark.parametrize("activation,output", [
    ("leaky_relu", "sigmoid"), ("elu", "sigmoid"), ("gelu", "sigmoid"),
    ("swish", "sigmoid"), ("mish", "sigmoid"), ("relu", "tanh"),
])
def test_other_activations_forward(activation, output):
    c, hw = 4, 16
    jmodel, params = _jax_model_and_params(
        hw, base_channels=c, dropout=0.0, intermediate_activation=activation,
        output_activation=output)
    model = _port(params, base_channels=c, dropout=0.0, intermediate_activation=activation,
                  output_activation=output).eval()
    x = np.random.default_rng(1).uniform(size=(2, hw, hw, 1)).astype(np.float32)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = model(torch.tensor(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_state_dict_keys_are_the_reference_keys(dropout):
    _, params = _jax_model_and_params(16, base_channels=4, dropout=dropout)
    exported = export_torch_state_dict(params, dropout=dropout)
    ours = state_dict_from_jax(params, dropout=dropout)
    model = UNet(base_channels=4, dropout=dropout)
    assert set(model.state_dict()) == set(exported) == set(ours)
    for k, v in exported.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model.load_state_dict(ours)  # strict


def test_prelu_weight_is_shared_and_imported():
    _, params = _jax_model_and_params(16, base_channels=4, dropout=0.2,
                                      intermediate_activation="prelu")
    params["params"]["enc2"]["prelu_alpha"] = np.array([0.5], np.float32)
    model = _port(params, base_channels=4, dropout=0.2, intermediate_activation="prelu")
    sd = model.state_dict()
    assert float(sd["enc2.conv.1.weight"]) == float(sd["enc2.conv.4.weight"]) == 0.5
    assert model.enc2.conv[1] is model.enc2.conv[4]


def test_parameter_count_matches_reference():
    assert count_parameters(UNet(base_channels=64)) == 20_543_809
    assert count_parameters(UNet(base_channels=8, intermediate_activation="prelu")) == \
        count_parameters(UNet(base_channels=8)) + 9


@pytest.mark.parametrize("family", ["lecun", "torch"])
def test_init_families(family):
    g = torch.Generator().manual_seed(0)
    model = UNet(base_channels=16, param_init=family, generator=g)
    conv = model.dec3.conv[0]  # Conv2d(128 -> 64): fan_in = 128 * 9
    up = model.up3  # ConvTranspose2d(128 -> 64, k=2): weight (in, out, 2, 2)
    fan_conv = 128 * 9
    if family == "lecun":
        for m, fan in ((conv, fan_conv), (up, 128 * 4)):
            w = m.weight.detach()
            np.testing.assert_allclose(float(w.std()), (1.0 / fan) ** 0.5, rtol=0.05)
            assert float(w.abs().max()) <= 2.0 * (1.0 / fan) ** 0.5 / 0.8796256610342398 + 1e-6
            assert torch.all(m.bias == 0)
    else:
        for m, fan in ((conv, fan_conv), (up, 64 * 4)):
            bound = fan ** -0.5
            assert float(m.weight.detach().abs().max()) <= bound
            assert float(m.bias.detach().abs().max()) <= bound
            np.testing.assert_allclose(float(m.weight.detach().std()), bound / 3 ** 0.5, rtol=0.05)
    again = UNet(base_channels=16, param_init=family, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.dec3.conv[0].weight, conv.weight)


def test_dropout_draws_from_the_generator():
    model = UNet(base_channels=4, dropout=0.5).train()
    x = torch.rand(2, 1, 16, 16)
    a = model(x, torch.Generator().manual_seed(3))
    b = model(x, torch.Generator().manual_seed(3))
    c = model(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    assert torch.equal(model(x), model(x, torch.Generator().manual_seed(5)))


def test_rejects_unknown_options():
    for kw in ({"output_activation": "softmax"}, {"param_init": "xavier"},
               {"intermediate_activation": "tanhshrink"}):
        with pytest.raises(ValueError):
            UNet(base_channels=4, **kw)
