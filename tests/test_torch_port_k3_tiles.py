"""PyTorch port: the tile plan of the halo-padded physics kernels (K3) and
the tile-wise plain version of their backward.

The backward kernel computes dp tile by tile, each tile from its own p
with a two-pixel halo, and a tile on the image's edge also writes the
ghost ring beside it.  ``padded_physics_sums_bwd_tiled`` does the same in
plain PyTorch with the kernel's index rules (tile plan, halo, fields on a
one-pixel ring that are 0 outside the interior, guarded ring taps), so an
index mistake shows here, on the CPU.  It is held against autograd of the
plain sums and against the VJP of the JAX package's Pallas kernel
(interpreted on the CPU, as its own tests run it).

Tolerances.  Against autograd, over drawn shapes with cotangents of
N(0, 1): both sides compute the same float32 terms in different orders,
so gradients agree to atol 1e-6·max|g| + rtol 1e-5, the bar the kernel is
held to on the card.  Against the JAX VJP, with the cotangent of a mean
(1/n), as ``tests/test_torch_port_halo.py`` holds K3's plain version: sums
rtol 1e-5, gradients atol 1e-6 on the whole padded block, ring included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from physics_informed_image_segmentation_tpu.ops import pallas_physics as jax_pp
from physics_informed_image_segmentation_tpu_torch.ops import padded_physics_kernel as K3

D, A, EPS = 5.0, 0.5, 0.05
CORNERS = np.s_[:, [0, 0, -1, -1], [0, -1, 0, -1]]


def _case(seed, shape, saturated=False):
    rng = np.random.default_rng(seed)
    if saturated:
        p = (rng.integers(0, 3, size=shape) / 2.0).astype(np.float32)  # {0, 0.5, 1}
    else:
        p = rng.uniform(0.02, 0.98, size=shape).astype(np.float32)
    return p, rng.normal(size=(shape[0], 2)).astype(np.float32)


def _autograd(p, cot, use_reaction):
    pp = torch.tensor(p, requires_grad=True)
    sums = K3.padded_physics_sums_reference(pp, D, A, EPS, use_reaction)
    return torch.autograd.grad(sums, pp, torch.tensor(cot))[0]


def _tiled(p, cot, use_reaction, tile_h=None, tile_w=None):
    return K3.padded_physics_sums_bwd_tiled(torch.tensor(p), torch.tensor(cot), D, A, EPS,
                                            use_reaction, tile_h, tile_w)


def _assert_grad_close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    tol = 1e-6 * np.abs(ref).max() + 1e-5 * np.abs(ref)
    assert np.all(np.abs(ours - ref) <= tol), float(np.abs(ours - ref).max())


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), tile_h=st.integers(1, 12),
       tile_w=st.sampled_from([4, 8, 64]), use_reaction=st.booleans(),
       saturated=st.booleans(), seed=st.integers(0, 2**16))
def test_tiled_backward_matches_autograd(h, w, tile_h, tile_w, use_reaction, saturated, seed):
    p, cot = _case(seed, (2, h + 2, w + 2), saturated)
    dp = _tiled(p, cot, use_reaction, tile_h, tile_w)
    assert not bool(torch.isnan(dp).any()), "a padded position no tile writes"
    _assert_grad_close(dp, _autograd(p, cot, use_reaction))
    assert np.all(dp.numpy()[CORNERS] == 0.0)


@pytest.mark.parametrize("shape,tile", [
    ((1, 3, 3), (1, 4)), ((2, 3, 130), (8, 64)), ((1, 4, 130), (32, 64)), ((3, 3, 9), (2, 4)),
    ((1, 9, 3), (4, 4)), ((2, 5, 5), (1, 64)), ((3, 37, 53), (8, 64)), ((9, 13, 67), (8, 64)),
    ((1, 34, 66), (16, 64)), ((1, 35, 131), (32, 64)),
])
@pytest.mark.parametrize("use_reaction", [True, False])
def test_tiled_backward_small_and_ragged_shapes(shape, tile, use_reaction):
    """Interiors of one pixel's height or width (a tile that is all ring on
    two sides), odd pitches, ragged last tiles both ways, and the kernels'
    own tile sizes."""
    p, cot = _case(21, shape)
    _assert_grad_close(_tiled(p, cot, use_reaction, *tile), _autograd(p, cot, use_reaction))


@pytest.mark.parametrize("shape,use_reaction", [
    ((2, 18, 26), True), ((1, 4, 130), True), ((3, 9, 35), False), ((8, 34, 34), True),
])
@pytest.mark.parametrize("tile", [None, (3, 8)])
def test_tiled_backward_matches_pallas_vjp(shape, use_reaction, tile):
    p, _ = _case(22, shape)
    b, hp, wp = shape
    cot = (np.random.default_rng(23).normal(size=(b, 2)) / (b * (hp - 2) * (wp - 2)))
    cot = cot.astype(np.float32)
    ref, vjp = jax.vjp(lambda q: jax_pp.padded_physics_sums(q, D, A, EPS, use_reaction),
                       jnp.asarray(p))
    (ref_grad,) = vjp(jnp.asarray(cot))
    sums = K3.padded_physics_sums(torch.tensor(p), D, A, EPS, use_reaction)
    np.testing.assert_allclose(sums.numpy(), np.asarray(ref), rtol=1e-5, atol=0)
    dp = _tiled(p, cot, use_reaction, *(tile or (None, None))).numpy()
    np.testing.assert_allclose(dp, np.asarray(ref_grad), atol=1e-6)
    assert np.all(dp[CORNERS] == 0.0)


@pytest.mark.parametrize("use_reaction", [True, False])
def test_the_ghost_ring_gets_the_zero_boundary_transpose(use_reaction):
    """No folds: the top ghost row receives exactly what its one neighbour
    inside reads from it, 2·c_rd·D·r − ½·c_pf·eps·gy of the first interior
    row, and the left ghost column 2·c_rd·D·r − ½·c_pf·eps·gx of the first
    interior column (the same terms the kernel adds, in its order)."""
    p, cot = _case(24, (2, 9, 11))
    dp = _tiled(p, cot, use_reaction, 4, 4)
    pt, c = torch.tensor(p), torch.tensor(cot)
    u = pt[:, 1:-1, 1:-1]
    r = D * (pt[:, :-2, 1:-1] + pt[:, 2:, 1:-1] + pt[:, 1:-1, :-2] + pt[:, 1:-1, 2:] - 4.0 * u)
    if use_reaction:
        r = r + u * (1.0 - u) * (u - A)
    gx, gy = 0.5 * (pt[:, 1:-1, 2:] - pt[:, 1:-1, :-2]), 0.5 * (pt[:, 2:, 1:-1] - pt[:, :-2, 1:-1])
    k_lap, k_pf = (c[:, 0] * 2.0 * D)[:, None], (c[:, 1] * EPS)[:, None]
    top = k_lap * r[:, 0] + k_pf * (-0.5 * gy[:, 0])
    left = k_lap * r[:, :, 0] + k_pf * (-0.5 * gx[:, :, 0])
    torch.testing.assert_close(dp[:, 0, 1:-1], top, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(dp[:, 1:-1, 0], left, rtol=1e-6, atol=1e-5)
    assert bool((dp[:, [0, 0, -1, -1], [0, -1, 0, -1]] == 0).all())


def test_tiled_backward_defaults_to_the_kernels_plan():
    p, cot = _case(25, (2, 22, 72))
    plan = K3.tile_plan(2, 20, 70)
    assert torch.equal(_tiled(p, cot, True), _tiled(p, cot, True, plan.tile_h, plan.tile_w))


def test_a_tap_outside_its_ring_raises(monkeypatch):
    """The guard on the tile-wise version's own indexing: with tiles one
    row taller than the fields' ring allows, a tap falls outside and the
    call raises instead of reading a clamped neighbour."""
    p, cot = _case(26, (1, 10, 10))
    real = K3.tiles

    def taller(h, w, tile_h, tile_w):
        for y0, x0, rows, cols in real(h, w, tile_h, tile_w):
            yield y0, x0, rows + (1 if y0 + rows < h else 0), cols  # one row too many

    monkeypatch.setattr(K3, "tiles", taller)
    with pytest.raises(AssertionError, match="outside its ring"):
        _tiled(p, cot, True, 4, 4)


def _assert_plan_covers(b, h, w, tile_h, tile_w):
    """Every interior pixel in exactly one tile (forward), and every padded
    position, ghost ring and corners included, written by exactly one
    block (backward): its tile or the ring it owns."""
    interior = np.zeros((h, w), np.int64)
    padded = np.zeros((h + 2, w + 2), np.int64)
    n = 0
    for y0, x0, rows, cols in K3.tiles(h, w, tile_h, tile_w):
        assert 1 <= rows <= tile_h and 1 <= cols <= tile_w
        interior[y0:y0 + rows, x0:x0 + cols] += 1
        padded[y0 + 1:y0 + 1 + rows, x0 + 1:x0 + 1 + cols] += 1
        for y, x in K3.ring_positions(h, w, y0, x0, rows, cols):
            assert y in (-1, h) or x in (-1, w), "a ring position inside the interior"
            padded[y + 1, x + 1] += 1
        n += 1
    assert (interior == 1).all() and (padded == 1).all()
    return n


@pytest.mark.parametrize("shape", [
    (8, 130, 130), (1, 1026, 1026), (1, 3, 3), (2, 3, 130), (9, 13, 67), (3, 37, 53),
    (1, 4, 4098), (1, 2050, 5), (70000, 3, 3),
])
def test_tile_plan_covers_every_position_once_within_shared_memory(shape):
    b, hp, wp = shape
    h, w = hp - 2, wp - 2
    plan = K3.tile_plan(b, h, w)
    assert plan.tile_w == 64 and plan.tile_h in (8, 16, 32)
    assert _assert_plan_covers(b, h, w, plan.tile_h, plan.tile_w) == plan.per_image
    assert b * plan.per_image < 2**31
    assert K3.shared_bytes(plan.tile_h, False) <= 227 * 1024
    assert K3.shared_bytes(plan.tile_h, True) <= 48 * 1024  # no opt-in to large shared memory


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 300), w=st.integers(1, 300), tile_h=st.integers(1, 32),
       tile_w=st.sampled_from([1, 4, 64]))
def test_drawn_tilings_cover_every_position_once(h, w, tile_h, tile_w):
    _assert_plan_covers(1, h, w, tile_h, tile_w)


def test_tile_plan_gives_both_path_shapes_a_block_for_nearly_every_sm():
    assert K3.tile_plan(8, 128, 128) == (16, 64, 8, 2)  # 128 blocks
    assert K3.tile_plan(1, 1024, 1024) == (32, 64, 32, 16)  # 512 blocks
    assert K3.shared_bytes(32, True) == 4 * (36 * 70 + 3 * 34 * 66)


@pytest.mark.parametrize("shape,offset,expected", [
    ((1, 1026, 1026), 0, 8), ((8, 130, 130), 0, 8), ((3, 37, 53), 0, 4), ((3, 9, 35), 0, 4),
    ((8, 130, 130), 1, 4), ((2, 18, 26), 2, 8),
])
def test_copy_width_follows_the_pitch_and_the_alignment(shape, offset, expected):
    """8-byte copies need an even padded row and an 8-byte aligned block;
    a block that starts one float into its storage takes 4-byte copies."""
    p = torch.empty(int(np.prod(shape)) + 4)[offset:offset + int(np.prod(shape))].view(shape)
    assert p.data_ptr() % 8 == (4 * offset) % 8
    assert K3.copy_bytes(p) == expected


def test_the_breakdown_variants_still_apply_to_the_kernel_source():
    """``utils/k3_breakdown.py`` times variants of ``csrc/padded_physics.cu``
    made by replacing text: each replacement must still find its text."""
    from physics_informed_image_segmentation_tpu_torch.utils import k3_breakdown

    sources = k3_breakdown._sources()
    assert set(sources) == {"kernel", "nofinish", "noticket", "nocompute", "noload"}
    assert "kMaxTileH = 64;" in sources["kernel"]
    assert all(text != sources["kernel"] for name, text in sources.items() if name != "kernel")
