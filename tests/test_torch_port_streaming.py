"""PyTorch port: the streamed input pipeline and the chunked train step,
held against the JAX package and against the port's resident epoch.

* ``batch_iterator`` and ``chunk_batches`` give the JAX package's orders,
  padding and ``valid`` vectors bit for bit (both are numpy, seeded by
  ``SeedSequence([seed, epoch])``).
* ``prefetch_to_device`` keeps order and values and raises the producer's
  exception at the consumer (CPU tensors here; the card's pinned copies run
  in ``chip_smoke.py::drive_streaming``).
* Streamed per-batch steps equal the resident epoch on the same order, and
  ``make_train_chunk_fn`` equals stepping its batches one by one, bit for
  bit.  A chunk's all-padding step leaves parameters, moments, step count
  and the dropout generator bit-equal: with dropout 0.2 the next real step
  equals the one taken without the padding step.
* The chunk function against JAX ``make_train_chunk_fn`` with the Pallas
  physics backend (interpreted) on the same batches, dropout 0: parameters
  atol 1e-5, per-step metrics rtol 1e-5 (NaN where both give NaN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.data import streaming as jax_streaming
from physics_informed_image_segmentation_tpu.models import UNet as JaxUNet
from physics_informed_image_segmentation_tpu.train import engine as jax_engine
from physics_informed_image_segmentation_tpu.train.objective import LossConfig as JaxLossConfig
from physics_informed_image_segmentation_tpu_torch.data import (
    HostDataset,
    batch_iterator,
    chunk_batches,
    make_blobs,
    prefetch_to_device,
)
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.train import LossConfig, engine
from physics_informed_image_segmentation_tpu_torch.utils.weights import state_dict_from_jax

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


def _host(n, seed=0, hw=HW):
    images, masks = make_blobs(n, hw, hw, seed=seed)
    return HostDataset(n, images, masks)


def _state(dropout=0.0, optimizer="adamw", seed=4):
    model = UNet(base_channels=C, dropout=dropout, generator=torch.Generator().manual_seed(seed))
    return engine.create_train_state(model, LR, optimizer=optimizer, dropout_seed=9)


def _snapshot(state) -> list:
    opt = state.optimizer.state_dict()
    return ([p.detach().clone() for p in state.model.parameters()]
            + [t.clone() for t in (*opt["m"], *opt["v"])]
            + [torch.tensor(state.optimizer.count), state.dropout_generator.get_state()])


def _assert_bit_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _tensors(item):
    return tuple(torch.as_tensor(a) for a in item)


# --------------------------------------------------------------------------
# the numpy pipeline against JAX's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,batch,shuffle,epoch", [(10, 4, True, 0), (10, 4, True, 3),
                                                   (8, 4, False, 0), (7, 3, True, 1)])
def test_batch_iterator_and_chunks_match_jax(n, batch, shuffle, epoch):
    ids = np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1) * np.ones((1, 2, 3, 1), np.float32)
    ours = HostDataset(n, ids, ids + 100)
    theirs = jax_streaming.HostDataset(n, ids, ids + 100)
    kw = dict(shuffle=shuffle, seed=17, epoch=epoch)
    a = list(batch_iterator(ours, batch, **kw))
    b = list(jax_streaming.batch_iterator(theirs, batch, **kw))
    assert len(a) == len(b) == -(-n // batch)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and np.array_equal(u, v)
    for k in (1, 2, 3):
        ca = list(chunk_batches(iter(a), k))
        cb = list(jax_streaming.chunk_batches(iter(b), k))
        assert len(ca) == len(cb)
        for x, y in zip(ca, cb):
            for u, v in zip(x, y):
                assert u.shape == v.shape and np.array_equal(u, v)
        assert ca[-1][2].shape == (k, batch)


def test_host_dataset_decode_callback():
    calls = []

    def decode(idx):
        calls.append(idx.copy())
        x = idx.astype(np.float32).reshape(-1, 1, 1, 1)
        return x, x * 2

    data = HostDataset(5, decode=decode)
    batches = list(batch_iterator(data, 2, shuffle=False))
    assert [list(c) for c in calls] == [[0, 1], [2, 3], [4, 0]]
    assert batches[-1][2].tolist() == [1.0, 0.0]
    with pytest.raises(ValueError):
        HostDataset(3)


def test_prefetch_keeps_order_and_values_and_raises():
    items = [(np.full((2, 3), i, np.float32), np.arange(i, i + 2)) for i in range(7)]
    out = list(prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(out) == 7
    for (x, y), (tx, ty) in zip(items, out):
        assert isinstance(tx, torch.Tensor) and np.array_equal(tx.numpy(), x)
        assert np.array_equal(ty.numpy(), y)

    cut = list(prefetch_to_device(iter(items[:2]), device="cpu", shard=lambda t: t[:1]))
    assert cut[1][0].shape == (1, 3) and cut[1][1].tolist() == [1]

    def failing():
        yield items[0]
        raise KeyError("decode failed")

    it = prefetch_to_device(failing(), device="cpu")
    assert next(it)[0][0, 0] == 0
    with pytest.raises(KeyError, match="decode failed"):
        next(it)

    # a consumer that stops early stops the producer
    gen = prefetch_to_device(iter(items), size=1, device="cpu")
    next(gen)
    gen.close()


# --------------------------------------------------------------------------
# streamed steps and chunks against the resident epoch and against JAX
# --------------------------------------------------------------------------


def test_streamed_steps_equal_the_resident_epoch():
    data, batch, seed, epoch = _host(10), 4, 3, 1
    cfg = LossConfig(**PHYSICS)
    streamed = _state()
    step = engine.make_train_step_fn(cfg)
    for x, y, v in prefetch_to_device(
            batch_iterator(data, batch, shuffle=True, seed=seed, epoch=epoch), device="cpu"):
        streamed, _ = step(streamed, x, y, v)

    # the same order as a resident plan
    order = np.arange(data.n)
    np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(order)
    idx = torch.tensor(np.concatenate([order, [0, 0]]).reshape(3, batch))
    valid = torch.tensor([1.0] * 10 + [0.0] * 2).reshape(3, batch)
    resident = _state()
    resident, _ = engine.make_train_epoch_fn(cfg)(
        resident, torch.tensor(data.images), torch.tensor(data.masks), idx, valid)
    _assert_bit_equal(_snapshot(streamed), _snapshot(resident))


@pytest.mark.parametrize("optimizer", ["adamw", "pallas_adamw"])
def test_chunk_equals_per_batch_steps(optimizer):
    data, batch = _host(10, seed=1), 4
    cfg = LossConfig(**PHYSICS)
    batches = list(batch_iterator(data, batch, shuffle=True, seed=2))
    chunked, stepped = _state(0.2, optimizer), _state(0.2, optimizer)
    chunk = engine.make_train_chunk_fn(cfg)
    step = engine.make_train_step_fn(cfg)
    outs = []
    for xs, ys, vs in chunk_batches(iter(batches), 2):  # 3 batches: the last chunk padded
        chunked, out = chunk(chunked, *_tensors((xs, ys, vs)))
        outs.append(out)
    per_step = []
    for x, y, v in batches:
        stepped, out = step(stepped, *_tensors((x, y, v)))
        per_step.append(out)
    _assert_bit_equal(_snapshot(chunked), _snapshot(stepped))
    assert chunked.optimizer.count == 3
    assert outs[1]["loss"].shape == (2,)
    for k, v in per_step[2].items():
        assert torch.equal(outs[1][k][0], v), k
    pad = {k: float(v[1]) for k, v in outs[1].items()}
    assert np.isnan(pad["loss"]) and pad["dice_loss"] == 0.0 and pad["n"] == 0.0


def test_all_padding_step_is_a_no_op():
    """[real, padding] then a real step equals [real] then the same step,
    moments, count and dropout stream included (dropout 0.2)."""
    data = _host(8, seed=5)
    cfg = LossConfig(**PHYSICS)
    (x0, y0, v0), (x1, y1, v1) = list(batch_iterator(data, 4, shuffle=False))
    chunk = engine.make_train_chunk_fn(cfg)
    padded, plain = _state(0.2), _state(0.2)
    xs, ys = np.stack([x0, x1]), np.stack([y0, y1])
    padded, _ = chunk(padded, *_tensors((xs, ys, np.stack([v0, np.zeros_like(v1)]))))
    plain, _ = chunk(plain, *_tensors((xs[:1], ys[:1], v0[None])))
    _assert_bit_equal(_snapshot(padded), _snapshot(plain))
    assert padded.optimizer.count == 1
    for st in (padded, plain):
        chunk(st, *_tensors((xs[1:], ys[1:], v1[None])))
    _assert_bit_equal(_snapshot(padded), _snapshot(plain))


def test_chunk_matches_jax_chunk_fn():
    jmodel = JaxUNet(base_channels=C, dropout=0.0, dtype=jnp.float32)
    params = jmodel.init(jax.random.key(1), jnp.zeros((1, HW, HW, 1), jnp.float32))
    weights = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), dropout=0.0)
    data = _host(6, seed=7)
    chunks = list(chunk_batches(batch_iterator(data, 4, shuffle=True, seed=4), 3))
    assert len(chunks) == 1 and chunks[0][2][-1].sum() == 0  # one padding step

    jstate = jax_engine.create_train_state(jmodel, jax.random.key(0), LR, params=params)
    jchunk = jax_engine.make_train_chunk_fn(jmodel, JaxLossConfig(backend="pallas", **PHYSICS))
    jstate, jout = jchunk(jstate, *(jnp.asarray(a) for a in chunks[0]))

    model = UNet(base_channels=C, dropout=0.0)
    model.load_state_dict(weights)
    state = engine.create_train_state(model, LR)
    state, out = engine.make_train_chunk_fn(LossConfig(**PHYSICS))(state, *_tensors(chunks[0]))

    assert state.optimizer.count == int(jstate.step) == 2
    assert set(out) == set(jout)
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jout[k]), rtol=1e-5, atol=1e-7,
                                   equal_nan=True, err_msg=k)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), dropout=0.0)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
