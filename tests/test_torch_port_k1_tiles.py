"""PyTorch port: the tile plan of the fused physics-sums kernels and the
tile-wise plain version of their backward.

The backward kernel computes du and dt tile by tile, each tile from its
own u with a two-pixel mirrored halo.  ``fused_physics_sums_bwd_tiled``
does the same in plain PyTorch with the kernel's index rules (tile plan,
halo, fold guards), so a halo or fold mistake shows here, on the CPU.  It
is held against autograd of the plain sums and against the VJP of the JAX
package's Pallas kernel (interpreted on the CPU, as its own tests run it).

Tolerance: both sides compute the same float32 terms in different orders,
so gradients agree to atol 1e-6·max|g| + rtol 1e-5, the bar the kernel is
held to on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from physics_informed_image_segmentation_tpu.ops import pallas_physics as jax_pp
from physics_informed_image_segmentation_tpu_torch.ops import physics_kernel as K

D, A, EPS = 5.0, 0.5, 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _case(seed, shape, masked=False, saturated=False):
    rng = np.random.default_rng(seed)
    if saturated:
        u = rng.integers(0, 3, size=shape).astype(np.float32) / 2.0  # {0, 0.5, 1}
    else:
        u = rng.uniform(0.02, 0.98, size=shape).astype(np.float32)
    t = rng.uniform(0.1, 0.9, size=shape).astype(np.float32)  # a differentiable point for dt
    m = np.ones((shape[0], 1), np.float32)
    if masked:
        m[::2] = 0.0
    cot = rng.normal(size=(shape[0], 6)).astype(np.float32)
    return u, t, m, cot


def _autograd(u, t, m, cot, use_reaction):
    uu, tt = torch.tensor(u, requires_grad=True), torch.tensor(t, requires_grad=True)
    sums = K.fused_physics_sums_reference(uu, tt, torch.tensor(m), D, A, EPS, use_reaction)
    return torch.autograd.grad(sums, (uu, tt), torch.tensor(cot))


def _assert_grad_close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    tol = 1e-6 * np.abs(ref).max() + 1e-5 * np.abs(ref)
    assert np.all(np.abs(ours - ref) <= tol), float(np.abs(ours - ref).max())


def _tiled(u, t, m, cot, use_reaction, need_dt, tile_h, tile_w):
    return K.fused_physics_sums_bwd_tiled(
        torch.tensor(u), torch.tensor(t), torch.tensor(m), torch.tensor(cot), D, A, EPS,
        use_reaction, need_dt, tile_h, tile_w)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(h=st.integers(2, 40), w=st.integers(2, 40), tile_h=st.integers(1, 12),
       tile_w=st.integers(1, 12), masked=st.booleans(), use_reaction=st.booleans(),
       need_dt=st.booleans(), seed=st.integers(0, 2**16))
def test_tiled_backward_matches_autograd(h, w, tile_h, tile_w, masked, use_reaction, need_dt,
                                         seed):
    u, t, m, cot = _case(seed, (2, h, w), masked=masked)
    du, dt = _tiled(u, t, m, cot, use_reaction, need_dt, tile_h, tile_w)
    du_ref, dt_ref = _autograd(u, t, m, cot, use_reaction)
    _assert_grad_close(du, du_ref)
    if need_dt:
        _assert_grad_close(dt, dt_ref)
    else:
        assert dt is None
    if masked:
        assert bool((du[0] == 0).all())


@pytest.mark.parametrize("shape,tile", [
    ((1, 2, 2), (1, 1)), ((1, 2, 5), (2, 2)), ((2, 3, 3), (2, 2)), ((1, 4, 4), (2, 2)),
    ((1, 4, 3), (3, 2)), ((1, 5, 5), (4, 4)), ((2, 3, 70), (8, 64)), ((1, 17, 23), (8, 64)),
    ((1, 33, 130), (16, 64)), ((1, 9, 65), (8, 64)),
])
@pytest.mark.parametrize("use_reaction", [True, False])
def test_tiled_backward_small_and_ragged_shapes(shape, tile, use_reaction):
    """H or W of 2 to 5 (a fold and a tile border on one pixel), tiles whose
    ring crosses the border on two sides, ragged last tiles, and the
    kernels' own tile sizes."""
    u, t, m, cot = _case(11, shape)
    du, dt = _tiled(u, t, m, cot, use_reaction, True, *tile)
    du_ref, dt_ref = _autograd(u, t, m, cot, use_reaction)
    _assert_grad_close(du, du_ref)
    _assert_grad_close(dt, dt_ref)


def test_tiled_backward_saturated_pixels_are_finite_and_match():
    u, t, m, cot = _case(12, (2, 9, 11), saturated=True)
    du, dt = _tiled(u, t, m, cot, True, True, 4, 4)
    assert bool(torch.isfinite(du).all() and torch.isfinite(dt).all())
    du_ref, dt_ref = _autograd(u, t, m, cot, True)
    _assert_grad_close(du, du_ref)
    _assert_grad_close(dt, dt_ref)


@pytest.mark.parametrize("shape,tile,use_reaction,need_dt", [
    ((2, 8, 8), (3, 5), True, True), ((1, 16, 12), (8, 64), True, True),
    ((3, 17, 23), (8, 8), True, False), ((2, 10, 10), (4, 3), False, True),
    ((1, 2, 40), (1, 7), True, True), ((1, 40, 2), (7, 1), False, True),
])
def test_tiled_backward_matches_pallas_vjp(shape, tile, use_reaction, need_dt):
    u, t, m, cot = _case(13, shape, masked=shape[0] > 1)
    _, vjp = jax.vjp(
        lambda p, q: jax_pp.fused_physics_sums(p, q, jnp.asarray(m), D, A, EPS, use_reaction),
        jnp.asarray(u), jnp.asarray(t))
    du_ref, dt_ref = vjp(jnp.asarray(cot))
    du, dt = _tiled(u, t, m, cot, use_reaction, need_dt, *tile)
    _assert_grad_close(du, du_ref)
    if need_dt:
        _assert_grad_close(dt, dt_ref)


def test_tiled_backward_defaults_to_the_kernels_plan():
    u, t, m, cot = _case(14, (2, 20, 70))
    args = [torch.tensor(x) for x in (u, t, m, cot)]
    plan = K.tile_plan(2, 20, 70)
    a = K.fused_physics_sums_bwd_tiled(*args, D, A, EPS)
    b = K.fused_physics_sums_bwd_tiled(*args, D, A, EPS, True, True, plan.tile_h, plan.tile_w)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_a_tap_outside_its_ring_raises(monkeypatch):
    """The guard on the tile-wise version's own indexing: with a halo tile
    cut one ring short, a guarded tap falls outside and the call raises
    instead of reading a clamped neighbour."""
    u, t, m, cot = _case(15, (1, 8, 8))
    real = K.tiles

    def shifted(h, w, tile_h, tile_w):
        for y0, x0, rows, cols in real(h, w, tile_h, tile_w):
            yield y0, x0, rows + (1 if y0 + rows < h else 0), cols  # one row too many

    monkeypatch.setattr(K, "tiles", shifted)
    with pytest.raises((AssertionError, IndexError, RuntimeError)):
        _tiled(u, t, m, cot, True, True, 4, 4)


@pytest.mark.parametrize("shape", [
    (8, 128, 128), (8, 512, 512), (2, 2, 2), (3, 5, 4), (3, 130, 70), (2, 24, 1000),
    (1, 3, 4096), (1, 3, 8192), (1, 4096, 4096), (70000, 2, 2), (1, 17, 23),
])
def test_tile_plan_covers_every_pixel_once_within_shared_memory(shape):
    b, h, w = shape
    plan = K.tile_plan(b, h, w)
    assert plan.tile_w == 64 and plan.tile_h in (8, 16, 32)
    assert plan.n_ty * plan.tile_h >= h > (plan.n_ty - 1) * plan.tile_h
    assert plan.n_tx * plan.tile_w >= w > (plan.n_tx - 1) * plan.tile_w
    # the tiles' extents: disjoint, inside the image, and all of it
    rows = np.zeros(h, np.int64)
    cols = np.zeros(w, np.int64)
    n = 0
    for y0, x0, r, c in K.tiles(h, w, plan.tile_h, plan.tile_w):
        assert 1 <= r <= plan.tile_h and 1 <= c <= plan.tile_w
        assert y0 % plan.tile_h == 0 and x0 % plan.tile_w == 0
        if x0 == 0:
            rows[y0:y0 + r] += 1
        if y0 == 0:
            cols[x0:x0 + c] += 1
        n += 1
    assert n == plan.per_image and b * n < 2**31
    assert (rows == 1).all() and (cols == 1).all()  # a grid of tiles: each pixel in one
    for bwd in (False, True):
        assert K.shared_bytes(plan.tile_h, bwd) <= 227 * 1024
    assert K.shared_bytes(32, True) <= 48 * 1024  # no opt-in to large shared memory needed


def test_tile_plan_gives_the_training_shape_a_block_for_nearly_every_sm():
    plan = K.tile_plan(8, 128, 128)
    assert plan == (16, 64, 8, 2) and 8 * plan.per_image == 128
    assert K.tile_plan(8, 512, 512).tile_h == 32
    assert K.tile_plan(1, 16, 16).tile_h == 8  # nothing reaches 128 blocks: the smallest


def test_every_pixel_of_a_small_image_is_in_exactly_one_tile():
    seen = np.zeros((13, 150), np.int64)
    for y0, x0, r, c in K.tiles(13, 150, 8, 64):
        seen[y0:y0 + r, x0:x0 + c] += 1
    assert (seen == 1).all()
