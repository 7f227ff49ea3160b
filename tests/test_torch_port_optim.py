"""PyTorch port: the optimizer family and the fused AdamW's plain version,
held against the JAX package's optimizers on the same random trees, and
the six optimizer names of ``create_train_state`` trained side by side.

Tolerance against JAX: rtol 1e-6 (atol 1e-9), the tolerance of
``test_torch_port_train.py::test_adamw_follows_optax``.  Bit-equality is
not reachable on the CPU: inside ``jit`` XLA's CPU compiler contracts
``(1-b1)·g + b1·m`` and ``(1-b2)·g² + b2·v`` into fused multiply-adds
(one rounding where the port rounds the product and the sum), which
moves m and v by an ulp in a few percent of the elements.  Stored
bfloat16 moments are compared to one bfloat16 ulp (rtol 2^-7): a float32
value an ulp away can round to the neighbouring bfloat16.  A moment is a
sum of two terms that can cancel, and the fused multiply-add's one
rounding moves it by an ulp of the terms, not of the sum: moments take
atol 1e-6·max|moment| beside their rtol.

Within the port, flat, grouped and fused AdamW are storage layouts of
the same arithmetic and must be bit-identical to AdamW.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from physics_informed_image_segmentation_tpu.train import optim as jax_optim
from physics_informed_image_segmentation_tpu.train import pallas_optim
from physics_informed_image_segmentation_tpu_torch.data import (
    DeviceDataset,
    epoch_batch_indices,
    make_blobs,
)
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.train import engine
from physics_informed_image_segmentation_tpu_torch.train.adamw_kernel import (
    AdamWPlan,
    FusedAdamW,
    _chunk_table,
    fused_adamw_,
    launch_counts,
    plan_groups,
)
from physics_informed_image_segmentation_tpu_torch.train.objective import LossConfig
from physics_informed_image_segmentation_tpu_torch.train.optim import (
    AdamW,
    FlatAdamW,
    GroupedAdamW,
    LowPrecisionAdamW,
)

LR, WD, STEPS = 3e-4, 1e-5, 5
# the leaves of {"a": (3,3,8,16), "b": {"w": (5,)}, "c": (64,)} in tree order
SHAPES = [(3, 3, 8, 16), (5,), (64,)]
RTOL, ATOL = 1e-6, 1e-9
BF16_RTOL = 2.0**-7
NAMES = ("adamw", "flat_adamw", "grouped_adamw", "pallas_adamw", "bf16m_adamw", "bf16mv_adamw")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(leaves):
    return {"a": leaves[0], "b": {"w": leaves[1]}, "c": leaves[2]}


def _inputs(seed=0):
    """Params and STEPS gradient sets of varied scale, from a numpy seed."""
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * 10.0 ** -(k % 3)).astype(np.float32) for s in SHAPES]
             for k in range(STEPS)]
    return params, grads


def _run_jax(step_fn, init, params, grads):
    """``step_fn(g, state, p) -> (p, state)`` jitted, as the JAX engine runs it."""
    p, state = _tree([jnp.asarray(x) for x in params]), init(_tree(params))
    step = jax.jit(step_fn)
    for g in grads:
        p, state = step(_tree([jnp.asarray(x) for x in g]), state, p)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(p)], state


def _optax_step(tx):
    def step(g, state, p):
        u, state = tx.update(g, state, p)
        return optax.apply_updates(p, u), state

    return step


def _run_port(opt_cls, params, grads, **kw):
    tp = [torch.tensor(x) for x in params]
    opt = opt_cls(tp, LR, WD, **kw)
    for g in grads:
        opt.step([torch.tensor(x) for x in g])
    assert opt.count == STEPS
    return [x.numpy() for x in tp], opt


def _assert_close(ours, ref, rtol=RTOL, atol=ATOL):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _assert_moments_close(ours, ref, rtol=RTOL):
    """``ours``: torch moments; ``ref``: JAX arrays, in the same order."""
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=rtol, atol=RTOL * float(np.abs(b).max(initial=0.0)))


def test_flat_adamw_matches_jax():
    params, grads = _inputs(0)
    tx = jax_optim.flat_adamw(LR, weight_decay=WD)
    ref, jstate = _run_jax(_optax_step(tx), tx.init, params, grads)
    ours, opt = _run_port(FlatAdamW, params, grads)
    _assert_close(ours, ref)
    assert len(opt.m) == 1 and opt.m[0].shape == (sum(int(np.prod(s)) for s in SHAPES),)
    _assert_moments_close([opt.m[0], opt.v[0]], [jstate.m, jstate.v])


@pytest.mark.parametrize("max_group_elems", [0, 60, 10_000_000])
def test_grouped_adamw_matches_jax(max_group_elems):
    """All leaves native, mixed, and all grouped."""
    params, grads = _inputs(1)
    tx = jax_optim.grouped_adamw(LR, weight_decay=WD, max_group_elems=max_group_elems)
    ref, jstate = _run_jax(_optax_step(tx), tx.init, params, grads)
    ours, opt = _run_port(GroupedAdamW, params, grads, max_group_elems=max_group_elems)
    _assert_close(ours, ref)
    _assert_moments_close(opt.m + opt.v, [jstate.m_flat, *jstate.m_big, jstate.v_flat,
                                          *jstate.v_big])


@pytest.mark.parametrize("v_bf16", [False, True], ids=["bf16m", "bf16mv"])
def test_low_precision_adamw_matches_jax(v_bf16):
    params, grads = _inputs(2)
    v_jdtype = jnp.bfloat16 if v_bf16 else jnp.float32
    v_dtype = torch.bfloat16 if v_bf16 else torch.float32
    tx = jax_optim.low_precision_adamw(LR, weight_decay=WD, v_dtype=v_jdtype)
    ref, jstate = _run_jax(_optax_step(tx), tx.init, params, grads)
    ours, opt = _run_port(LowPrecisionAdamW, params, grads, v_dtype=v_dtype)
    assert all(x.dtype == torch.bfloat16 for x in opt.m)
    assert all(x.dtype == v_dtype for x in opt.v)
    # a bfloat16 moment one ulp away moves the update by < 2^-7 of lr a step
    _assert_close(ours, ref, atol=STEPS * LR * BF16_RTOL)
    for ours_m, ref_m in ((opt.m, jstate.m), (opt.v, jstate.v)):
        rtol = BF16_RTOL if ours_m[0].dtype == torch.bfloat16 else RTOL
        _assert_moments_close(ours_m, jax.tree_util.tree_leaves(ref_m), rtol)


@pytest.mark.parametrize("bucket_bytes", [None, 4096], ids=["default_cap", "cap_4096"])
def test_fused_adamw_plain_version_matches_pallas_adamw(monkeypatch, bucket_bytes):
    """K2's plain version against ``pallas_adamw`` in interpret mode: with
    the default cap every leaf is bucketed; with 4096 bytes the (3,3,8,16)
    leaf takes the big-leaf XLA branch."""
    if bucket_bytes is not None:
        monkeypatch.setattr(pallas_optim, "_BUCKET_BYTES", bucket_bytes)
    params, grads = _inputs(3)
    tx = pallas_optim.pallas_adamw(LR, weight_decay=WD)
    ref, jstate = _run_jax(lambda g, s, p: tx.fused_apply_gradients(g, s, p), tx.init,
                           params, grads)
    before = launch_counts["adamw"]
    ours, opt = _run_port(FusedAdamW, params, grads)
    assert launch_counts["adamw"] == before  # CPU tensors never reach the kernel
    _assert_close(ours, ref)
    _assert_moments_close(opt.m + opt.v, jax.tree_util.tree_leaves((jstate.m, jstate.v)))


def test_adamw_variants_are_bit_identical_on_random_trees():
    params, grads = _inputs(4)
    ref, _ = _run_port(AdamW, params, grads)
    for cls, kw in ((FlatAdamW, {}), (GroupedAdamW, {"max_group_elems": 60}),
                    (GroupedAdamW, {"max_group_elems": 0}), (FusedAdamW, {})):
        ours, _ = _run_port(cls, params, grads, **kw)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_fused_adamw_checks_its_inputs():
    p = [torch.zeros(4)]
    with pytest.raises(TypeError, match="float32"):
        fused_adamw_(p, [torch.zeros(4, dtype=torch.float64)], [torch.zeros(4)],
                     [torch.zeros(4)], 0.1, 0.001, LR, WD)
    with pytest.raises(ValueError, match="contiguous"):
        fused_adamw_([torch.zeros(2, 2)], [torch.zeros(2, 2).t()], [torch.zeros(2, 2)],
                     [torch.zeros(2, 2)], 0.1, 0.001, LR, WD)
    with pytest.raises(ValueError, match="elements"):
        fused_adamw_(p, [torch.zeros(5)], [torch.zeros(4)], [torch.zeros(4)], 0.1, 0.001, LR,
                     WD)
    with pytest.raises(ValueError, match="equal lengths"):
        fused_adamw_(p, [], [torch.zeros(4)], [torch.zeros(4)], 0.1, 0.001, LR, WD)


# ------------------------------------------------------------------ K2's plan


def _covered(sizes, groups, chunk):
    """Elements of each tensor that the groups' blocks update, from the
    chunk tables alone, and the number of blocks."""
    covered = [0] * len(sizes)
    blocks = 0
    for indices, chunk_start in groups:
        table = _chunk_table(chunk_start)
        assert table.shape == (chunk_start[-1], 2) and table.dtype == np.int32
        blocks += len(table)
        seen = set()
        for tensor, within in table.tolist():
            k = indices[tensor]
            assert (k, within) not in seen and within * chunk < sizes[k]
            seen.add((k, within))
            covered[k] += min(chunk, sizes[k] - within * chunk)
        # blocks of one tensor are neighbours, in order
        assert table[:, 0].tolist() == sorted(table[:, 0].tolist())
    return covered, blocks


def test_plan_groups_for_the_unet_at_base_64():
    sizes = [p.numel() for p in UNet(base_channels=64).parameters()]
    assert len(sizes) == 46 and sum(sizes) == 20_543_809
    groups = plan_groups(sizes)
    assert len(groups) == 1  # one launch a step
    indices, chunk_start = groups[0]
    assert indices == list(range(46)) and len(chunk_start) == 47 and chunk_start[0] == 0
    assert [b - a for a, b in zip(chunk_start, chunk_start[1:])] == [-(-n // 4096) for n in sizes]
    covered, blocks = _covered(sizes, groups, 4096)
    assert covered == sizes and blocks == chunk_start[-1] == sum(-(-n // 4096) for n in sizes)


@pytest.mark.parametrize("sizes,chunk,max_tensors,n_groups", [
    ([1, 3, 64, 1023, 4096, 4097, 65537, 315, 0, 1 << 20], 4096, 64, 1),
    ([0, 5], 4096, 64, 1), ([0, 0], 4096, 64, 0),
    ([17 * i + 1 for i in range(70)], 4096, 64, 2),
    ([0, *range(1, 66), 0], 4096, 64, 2),
    ([5, 0, 9, 4, 8, 1], 4, 2, 3),
])
def test_plan_groups_zero_sizes_and_more_tensors_than_a_launch_takes(sizes, chunk, max_tensors,
                                                                     n_groups):
    groups = plan_groups(sizes, chunk, max_tensors)
    assert len(groups) == n_groups
    live = [k for k, n in enumerate(sizes) if n > 0]
    assert [k for indices, _ in groups for k in indices] == live  # in order, zero sizes left out
    for indices, chunk_start in groups:
        assert 1 <= len(indices) <= max_tensors and len(chunk_start) == len(indices) + 1
        assert chunk_start == [0, *np.cumsum([-(-sizes[k] // chunk) for k in indices]).tolist()]
    covered, _ = _covered(sizes, groups, chunk)
    assert covered == sizes


def _fused_pair(seed=6):
    params, grads = _inputs(seed)
    fused = FusedAdamW([torch.tensor(x) for x in params], LR, WD)
    plain = AdamW([torch.tensor(x) for x in params], LR, WD)
    return fused, plain, [[torch.tensor(x) for x in g] for g in grads]


def _assert_same_state(fused, plain):
    for a, b in zip(fused.params + fused.m + fused.v, plain.params + plain.m + plain.v):
        assert torch.equal(a, b)


def test_fused_adamw_keeps_its_plan_over_steps_with_fresh_gradients():
    fused, plain, grads = _fused_pair()
    plans = []
    for g in grads:
        fused.step([x.clone() for x in g])  # new gradient tensors every step, as autograd's
        plain.step(g)
        plans.append(fused._plan)
    assert all(p is plans[0] for p in plans) and isinstance(plans[0], AdamWPlan)
    assert fused.count == STEPS
    _assert_same_state(fused, plain)


@pytest.mark.parametrize("which", ["params", "m", "v"])
def test_fused_adamw_plans_anew_when_a_tensor_is_replaced(which):
    """A stale plan never updates the memory it was built from: after a
    parameter or moment tensor is replaced the next step builds a new plan,
    updates the new tensor and leaves the old one alone."""
    fused, plain, grads = _fused_pair(7)
    fused.step(grads[0])
    plain.step(grads[0])
    first = fused._plan
    old = getattr(fused, which)[1]
    kept = old.clone()
    getattr(fused, which)[1] = old.clone()  # same values at another address
    assert not first.matches(fused.params, fused.m, fused.v)
    fused.step(grads[1])
    plain.step(grads[1])
    assert fused._plan is not first and fused._plan.matches(fused.params, fused.m, fused.v)
    assert torch.equal(old, kept)
    _assert_same_state(fused, plain)


def test_fused_adamw_plans_anew_after_load_state_dict():
    fused, plain, grads = _fused_pair(8)
    fused.step(grads[0])
    plain.step(grads[0])
    other = FusedAdamW([p.clone() for p in fused.params], LR, WD)
    other.step(grads[1])  # it has a plan of its own now
    stale = other._plan
    other.params = [p.clone() for p in fused.params]
    other.load_state_dict(fused.state_dict())
    assert other._plan is None
    other.step(grads[1])
    plain.step(grads[1])
    assert other._plan is not stale
    _assert_same_state(other, plain)


def test_plan_validates_parameters_and_moments_once_and_gradients_every_step(monkeypatch):
    from physics_informed_image_segmentation_tpu_torch.train import adamw_kernel

    fused, _, grads = _fused_pair(9)
    checked = []
    real = adamw_kernel._check_tensor
    monkeypatch.setattr(adamw_kernel, "_check_tensor",
                        lambda name, *a: (checked.append(name), real(name, *a)))
    for g in grads[:3]:
        fused.step(g)
    assert sorted(checked) == sorted("pmv" * len(SHAPES))  # once, at the first step; no gradient failed
    with pytest.raises(TypeError, match=r"g\[1\] must be float32"):
        fused.step([grads[3][0], grads[3][1].double(), grads[3][2]])
    with pytest.raises(ValueError, match=r"g\[2\] has 63 elements, p\[2\] 64"):
        fused.step([grads[3][0], grads[3][1], grads[3][2][:63]])
    with pytest.raises(ValueError, match="expected 3 gradients"):
        fused.step(grads[3][:2])
    with pytest.raises(TypeError, match=r"m\[0\] must be float32"):
        AdamWPlan(fused.params, [x.double() for x in fused.m], fused.v)
    with pytest.raises(ValueError, match=r"v\[0\] must be contiguous"):
        AdamWPlan([torch.zeros(2, 2)], [torch.zeros(2, 2)], [torch.zeros(2, 2).t()])
    with pytest.raises(ValueError, match="equal lengths"):
        AdamWPlan(fused.params, fused.m[:2], fused.v)


def test_fused_adamw_copies_a_gradient_in_another_layout():
    p = [torch.arange(12.0).reshape(3, 4) / 7.0]
    g = torch.arange(12.0).reshape(4, 3).t() / 5.0  # same shape, other strides
    assert not g.is_contiguous()
    fused, plain = FusedAdamW([p[0].clone()], LR, WD), AdamW([p[0].clone()], LR, WD)
    fused.step([g])
    plain.step([g.contiguous()])
    _assert_same_state(fused, plain)


# ---------------------------------------------------------------- engine level


def test_create_train_state_takes_the_jax_names():
    model = UNet(base_channels=2)
    kinds = {name: type(engine.create_train_state(model, LR, optimizer=name).optimizer)
             for name in NAMES}
    assert kinds == {"adamw": AdamW, "flat_adamw": FlatAdamW, "grouped_adamw": GroupedAdamW,
                     "pallas_adamw": FusedAdamW, "bf16m_adamw": LowPrecisionAdamW,
                     "bf16mv_adamw": LowPrecisionAdamW}
    mv = engine.create_train_state(model, LR, optimizer="bf16mv_adamw").optimizer
    assert mv.m[0].dtype == mv.v[0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown optimizer 'sgd'; expected 'adamw'"):
        engine.create_train_state(model, LR, optimizer="sgd")


def _three_epochs(name):
    """Three epochs at base 4 on 32x32 blobs, f32, dropout 0.2 from one seed."""
    images, masks = make_blobs(8, 32, 32, seed=0)
    data = DeviceDataset.from_numpy(images, masks, "cpu")
    model = UNet(base_channels=4, generator=torch.Generator().manual_seed(7))
    state = engine.create_train_state(model, 1e-3, optimizer=name, dropout_seed=3)
    epoch_fn = engine.make_train_epoch_fn(LossConfig(pde_weight=1e-4, phase_field_weight=1e-4),
                                          compute_metrics=False)
    idx, valid = epoch_batch_indices(data.n, 4, shuffle=False)
    for _ in range(3):
        state, res = epoch_fn(state, data.images, data.masks, idx, valid)
    return [p.detach().clone() for p in model.parameters()], res["loss"], state


def test_optimizer_names_train_as_the_jax_package_requires():
    """flat/grouped/pallas bit-identical to adamw; the bfloat16-moment
    variants finite and within 2% of the exact loss (the JAX package's
    bars, tests/test_perf_equiv.py)."""
    ref_params, ref_loss, _ = _three_epochs("adamw")
    for name in NAMES[1:]:
        params, loss, state = _three_epochs(name)
        assert state.step == 6
        if name.startswith("bf16"):
            assert np.isfinite(loss) and abs(loss - ref_loss) / abs(ref_loss) < 0.02, name
        else:
            assert loss == ref_loss, name
            for a, b in zip(params, ref_params):
                assert torch.equal(a, b), name


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_state_dict_round_trip(name):
    """Save after 3 steps, load into a fresh optimizer: bit-equal state, and
    the next step matches the original's."""
    params, grads = _inputs(5)

    def make(ps):
        model = torch.nn.Module()
        for i, p in enumerate(ps):
            model.register_parameter(f"p{i}", torch.nn.Parameter(p))
        return engine.create_train_state(model, LR, optimizer=name).optimizer

    a = make([torch.tensor(x) for x in params])
    for g in grads[:3]:
        a.step([torch.tensor(x) for x in g])
    buf = io.BytesIO()
    torch.save(a.state_dict(), buf)
    b = make([p.detach().clone() for p in a.params])
    old_m = [x.data_ptr() for x in b.m]
    buf.seek(0)
    b.load_state_dict(torch.load(buf, weights_only=True))
    assert b.count == a.count == 3
    assert [x.data_ptr() for x in b.m] == old_m  # copied into its own tensors
    for x, y in zip(a.m + a.v, b.m + b.v):
        assert x.dtype == y.dtype and torch.equal(x, y)
    a.step([torch.tensor(x) for x in grads[3]])
    b.step([torch.tensor(x) for x in grads[3]])
    for x, y in zip(a.params, b.params):
        assert torch.equal(x, y)


def test_load_state_dict_rejects_another_optimizer():
    ps = [torch.zeros(3)]
    with pytest.raises(ValueError, match="cannot load"):
        FusedAdamW(ps, LR).load_state_dict(AdamW(ps, LR).state_dict())
    with pytest.raises(ValueError, match="does not match"):
        GroupedAdamW([torch.zeros(3), torch.zeros(5)], LR, max_group_elems=4).load_state_dict(
            GroupedAdamW([torch.zeros(3), torch.zeros(5)], LR, max_group_elems=10).state_dict())
