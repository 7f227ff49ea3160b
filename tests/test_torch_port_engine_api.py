"""PyTorch port: the engine's multi-epoch and flat-state entry points, D4 and
flip augmentation, and the profiling helpers.

* ``make_train_epochs_fn`` equals E calls of ``make_train_epoch_fn`` bit for
  bit (metrics and train state).
* ``create_train_state(flat=True)`` equals ``flat=False`` bit for bit over 3
  steps for "adamw" and "flat_adamw", with the ``state_dict`` keys kept and
  the parameters views of one buffer.
* Each of the eight D4 codes of the port (``data/augment.py::d4_apply``, the
  table ``serve.py`` shares) equals JAX ``data/augment.py::_apply_d4`` and
  ``serve.py::_d4_apply`` bit for bit; ``d4_augment`` gives each sample the
  code drawn from the generator, the same to image and mask;
  ``flip_augment`` on H != W.  The draws themselves cannot match JAX's keys.
* A run with ``augment=d4_augment`` checkpointed and resumed equals the
  uninterrupted run bit for bit.
* ``profiling.trace`` writes a Chrome trace.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu import serve as jax_serve
from physics_informed_image_segmentation_tpu.data import augment as jax_augment
from physics_informed_image_segmentation_tpu_torch.data import (
    DeviceDataset,
    d4_augment,
    epoch_batch_indices,
    flip_augment,
    make_blobs,
)
from physics_informed_image_segmentation_tpu_torch.data.augment import d4_apply, d4_invert
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.train import (
    LossConfig,
    create_train_state,
    make_train_epoch_fn,
    make_train_epochs_fn,
    make_train_step_fn,
    restore_train_state,
    save_train_state,
    tree_params,
)
from physics_informed_image_segmentation_tpu_torch.utils import profiling

C, HW, LR = 4, 32, 1e-3
PHYSICS = dict(pde_weight=1e-3, phase_field_weight=1e-4, diffusion_coeff=5.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _state(dropout=0.1, optimizer="adamw", flat=False):
    model = UNet(base_channels=C, dropout=dropout, generator=torch.Generator().manual_seed(6))
    return create_train_state(model, LR, optimizer=optimizer, dropout_seed=8, flat=flat)


def _snapshot(state) -> list:
    opt = state.optimizer.state_dict()
    return ([p.detach().clone() for p in state.model.parameters()]
            + [t.clone() for t in (*opt["m"], *opt["v"])]
            + [torch.tensor(state.optimizer.count), state.dropout_generator.get_state()])


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _data(n=6, seed=2):
    images, masks = make_blobs(n, HW, HW, seed=seed)
    return DeviceDataset.from_numpy(images, masks, "cpu")


def _plans(n, batch, epochs, seed=3):
    plans = [epoch_batch_indices(n, batch, shuffle=True,
                                 generator=torch.Generator().manual_seed(seed + e))
             for e in range(epochs)]
    return torch.stack([p[0] for p in plans]), torch.stack([p[1] for p in plans])


# --------------------------------------------------------------------------
# multi-epoch function and flat parameter storage
# --------------------------------------------------------------------------


def test_epochs_fn_equals_epoch_calls():
    data, cfg = _data(), LossConfig(**PHYSICS)
    idx, valid = _plans(data.n, 4, 3)
    many = _state()
    many, stacked = make_train_epochs_fn(cfg)(many, data.images, data.masks, idx, valid)
    one = _state()
    epoch_fn = make_train_epoch_fn(cfg)
    for e in range(3):
        one, res = epoch_fn(one, data.images, data.masks, idx[e], valid[e])
        for k, v in res.items():
            assert stacked[k].shape == (3,) and stacked[k][e] == v, (k, e)
    _assert_bit_equal(_snapshot(many), _snapshot(one))


@pytest.mark.parametrize("optimizer", ["adamw", "flat_adamw"])
def test_flat_params_equal_tree_params(optimizer):
    data, cfg = _data(4), LossConfig(**PHYSICS)
    runs = {}
    for flat in (False, True):
        state = _state(optimizer=optimizer, flat=flat)
        if flat:
            buf = state.flat_params
            assert buf.numel() == sum(p.numel() for p in state.model.parameters())
            for p in state.model.parameters():
                assert p.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
        step = make_train_step_fn(cfg)
        for b in range(3):
            sel = torch.tensor([b % 4, (b + 1) % 4])
            state, _ = step(state, data.images[sel], data.masks[sel], torch.ones(2))
        runs[flat] = state
    _assert_bit_equal(_snapshot(runs[True]), _snapshot(runs[False]))
    assert list(runs[True].model.state_dict()) == list(runs[False].model.state_dict())
    assert list(tree_params(runs[True])) == [n for n, _ in runs[True].model.named_parameters()]
    # the buffer still holds the trained values
    flat_now = torch.cat([p.reshape(-1) for p in runs[True].model.parameters()])
    assert torch.equal(flat_now, runs[True].flat_params)


# --------------------------------------------------------------------------
# augmentation
# --------------------------------------------------------------------------


def test_d4_codes_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 6, 6, 3)).astype(np.float32)
    for code in range(8):
        ours = d4_apply(torch.tensor(x), code).numpy()
        np.testing.assert_array_equal(ours, np.asarray(jax_serve._d4_apply(jnp.asarray(x), code)))
        for b in range(2):
            ref = jax_augment._apply_d4(jnp.asarray(x[b]), jnp.asarray(code))
            np.testing.assert_array_equal(ours[b], np.asarray(ref))
        np.testing.assert_array_equal(d4_invert(torch.tensor(ours), code).numpy(), x)


def test_d4_augment_applies_the_drawn_code_to_image_and_mask():
    images, masks = make_blobs(16, 12, 12, seed=4)
    x, y = torch.tensor(images), torch.tensor(masks)
    g = torch.Generator().manual_seed(5)
    codes = torch.randint(0, 8, (16,), generator=torch.Generator().manual_seed(5))
    xa, ya = d4_augment(g, x, y)
    assert len(set(codes.tolist())) > 4
    for b, c in enumerate(codes.tolist()):
        assert torch.equal(xa[b:b + 1], d4_apply(x[b:b + 1], c))
        assert torch.equal(ya[b:b + 1], d4_apply(y[b:b + 1], c))
    with pytest.raises(ValueError, match="square"):
        d4_augment(g, x[:, :, :10], y[:, :, :10])


def test_flip_augment_on_non_square_images():
    images, masks = make_blobs(12, 10, 14, seed=6)
    x, y = torch.tensor(images), torch.tensor(masks)
    xa, ya = flip_augment(torch.Generator().manual_seed(1), x, y)
    assert xa.shape == x.shape
    seen = set()
    for b in range(12):
        flips = [x[b], x[b].flip(1), x[b].flip(0), x[b].flip(0).flip(1)]
        match = [i for i, f in enumerate(flips) if torch.equal(xa[b], f)]
        assert match, b
        i = match[0]
        seen.add(i)
        ref = [y[b], y[b].flip(1), y[b].flip(0), y[b].flip(0).flip(1)][i]
        assert torch.equal(ya[b], ref)
    assert len(seen) > 2


def test_resume_with_augmentation_is_bit_equal(tmp_path):
    data, cfg = _data(), LossConfig(**PHYSICS)
    idx, valid = _plans(data.n, 4, 2, seed=7)
    epoch_fn = make_train_epoch_fn(cfg, augment=d4_augment)
    straight = _state(dropout=0.2)
    for e in range(2):
        straight, res_straight = epoch_fn(straight, data.images, data.masks, idx[e], valid[e])

    first = _state(dropout=0.2)
    first, _ = epoch_fn(first, data.images, data.masks, idx[0], valid[0])
    save_train_state(first, tmp_path)
    resumed = _state(dropout=0.2)
    restore_train_state(resumed, tmp_path)
    resumed, res_resumed = epoch_fn(resumed, data.images, data.masks, idx[1], valid[1])
    _assert_bit_equal(_snapshot(resumed), _snapshot(straight))
    assert res_resumed == res_straight

    # the hook changes the run: without it the same plan trains otherwise
    plain = _state(dropout=0.2)
    plain, _ = make_train_epoch_fn(cfg)(plain, data.images, data.masks, idx[0], valid[0])
    assert not torch.equal(next(plain.model.parameters()), next(first.model.parameters()))


# --------------------------------------------------------------------------
# profiling
# --------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr"):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    profiling.sync()
