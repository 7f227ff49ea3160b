"""PyTorch port: the native C++ polygon rasteriser (``data/native_raster.py``)
against PIL, against the JAX package's binding of the same source, and
built by several processes at once.

The cases and criteria against PIL are those of ``tests/test_native.py``.
The JAX binding builds ``native/build/librasterize.so`` in place, so the
repository's root ``conftest.py`` builds it once, before any xdist worker
starts; every test process then only loads it.  The port's library is
written to a temporary file and renamed into place.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw
from scipy.ndimage import binary_dilation

from physics_informed_image_segmentation_tpu_torch.data import (
    CocoSegmentationSource,
    load_split,
    rasterize_polygons,
    write_synthetic_coco,
)
from physics_informed_image_segmentation_tpu_torch.data.native_raster import (
    native_available,
    rasterize_batch_native,
    rasterize_native,
)
from physics_informed_image_segmentation_tpu_torch.ops.metrics import extract_boundaries_np

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pil_mask(annotations, H, W):
    img = Image.new("L", (W, H), 0)
    draw = ImageDraw.Draw(img)
    for ann in annotations:
        for poly in ann.get("segmentation", []):
            if len(poly) >= 6:
                pts = np.asarray(poly, np.float64).reshape(-1, 2)
                draw.polygon(pts.flatten().tolist(), outline=1, fill=1)
    return (np.array(img, np.float32) > 0).astype(np.float32)


def _circle(cy, cx, r, k=24):
    t = np.linspace(0, 2 * np.pi, k, endpoint=False)
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], 1).flatten().tolist()


def _star(cy, cx, r_out, r_in, k=5):
    pts = []
    for i in range(2 * k):
        r = r_out if i % 2 == 0 else r_in
        t = np.pi * i / k
        pts += [cx + r * np.cos(t), cy + r * np.sin(t)]
    return pts


def _random_scene(rng, H, W, n_cells):
    anns = []
    for _ in range(n_cells):
        cy = rng.uniform(0.1, 0.9) * H
        cx = rng.uniform(0.1, 0.9) * W
        r = rng.uniform(4, 0.2 * min(H, W))
        anns.append({"segmentation": [_circle(cy, cx, r)]})
    return anns


def _iou(a, b):
    inter = np.sum((a > 0) & (b > 0))
    union = np.sum((a > 0) | (b > 0))
    return inter / union if union else 1.0


def test_native_builds_here():
    assert native_available()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_scenes_agree_with_pil(seed):
    rng = np.random.default_rng(seed)
    H, W = 96, 112
    anns = _random_scene(rng, H, W, int(rng.integers(1, 5)))
    assert _iou(rasterize_native(anns, (H, W)), _pil_mask(anns, H, W)) > 0.95


def test_triangle_interior_is_exact():
    anns = [{"segmentation": [[10, 10, 50, 10, 30, 40]]}]
    ours = rasterize_native(anns, (64, 64))
    ref = _pil_mask(anns, 64, 64)
    near_boundary = binary_dilation(extract_boundaries_np(ref) > 0, iterations=1)
    assert (np.abs(ours - ref) > 0)[~near_boundary].sum() == 0


def test_small_polygons_are_skipped():
    assert rasterize_native([{"segmentation": [[0, 0, 10, 10]]}], (32, 32)).sum() == 0


def test_out_of_bounds_polygons_are_clipped():
    ours = rasterize_native([{"segmentation": [_circle(0, 0, 20)]}], (32, 32))
    assert np.isfinite(ours).all() and ours.sum() > 0


@pytest.mark.parametrize("anns,hw,min_iou", [
    ([{"segmentation": [_star(32, 32, 24, 10)]}], 64, 0.93),
    ([{"segmentation": [_circle(20, 20, 10)]}, {"segmentation": [_circle(26, 26, 10)]}], 48, 0.95),
    ([{"segmentation": [_circle(12, 12, 6), _circle(36, 36, 6)]}], 48, 0.95),
], ids=["concave-star", "overlapping", "multi-part"])
def test_concave_and_multi_part_polygons(anns, hw, min_iou):
    assert _iou(rasterize_native(anns, (hw, hw)), _pil_mask(anns, hw, hw)) > min_iou


def test_batch_matches_single():
    rng = np.random.default_rng(7)
    scenes = [_random_scene(rng, 64, 64, 3) for _ in range(6)]
    batch = rasterize_batch_native(scenes, (64, 64), n_threads=4)
    assert batch.shape == (6, 64, 64)
    for i, anns in enumerate(scenes):
        np.testing.assert_array_equal(batch[i], rasterize_native(anns, (64, 64)))
    assert rasterize_batch_native([], (16, 16)).shape == (0, 16, 16)


def test_coco_split_native_backend(tmp_path):
    image_dir, ann = write_synthetic_coco(tmp_path, n=4, seed=0)
    pil = CocoSegmentationSource(image_dir, ann, raster_backend="pil")
    native = load_split(image_dir, ann, raster_backend="native")
    assert native.masks.shape == pil.masks.shape
    np.testing.assert_array_equal(native.images, pil.images)
    assert (pil.masks == native.masks).mean() > 0.995
    with pytest.raises(ValueError, match="raster backend"):
        load_split(image_dir, ann, raster_backend="opencv")
    with pytest.raises(ValueError, match="raster backend"):
        rasterize_polygons([], (8, 8), (8, 8), backend="opencv")


def test_bit_equal_to_the_jax_binding():
    from physics_informed_image_segmentation_tpu.data import native_raster as jax_native

    assert jax_native.native_available(), jax_native._build_error
    rng = np.random.default_rng(11)
    scenes = [_random_scene(rng, 80, 72, 4) for _ in range(5)]
    scenes.append([{"segmentation": [_star(40, 36, 30, 12), _circle(10, 10, 30)]}])
    for anns in scenes:
        np.testing.assert_array_equal(rasterize_native(anns, (80, 72)),
                                      jax_native.rasterize_native(anns, (80, 72)))
    np.testing.assert_array_equal(rasterize_batch_native(scenes, (80, 72), n_threads=3),
                                  jax_native.rasterize_batch_native(scenes, (80, 72), 3))


_BUILDER = """
import sys
from pathlib import Path
import numpy as np
from physics_informed_image_segmentation_tpu_torch.utils import cuda_build
cuda_build.BUILD_DIR = Path(sys.argv[1])
from physics_informed_image_segmentation_tpu_torch.data import native_raster
mask = native_raster.rasterize_native([{"segmentation": [[2, 2, 28, 3, 15, 27]]}], (32, 32))
np.save(sys.argv[2], mask)
"""


def test_four_processes_build_at_once(tmp_path):
    """Four processes build the library into one empty directory at the
    same time: each loads a whole library and all four masks agree."""
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(build),
                               str(tmp_path / f"{i}.npy")], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(4)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, logs
    masks = [np.load(tmp_path / f"{i}.npy") for i in range(4)]
    assert masks[0].sum() > 0
    for m in masks[1:]:
        np.testing.assert_array_equal(m, masks[0])
    built = sorted(p.name for p in build.iterdir())
    assert len(built) == 1 and built[0].startswith("librasterize-") and built[0].endswith(".so")


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    from physics_informed_image_segmentation_tpu_torch.data import native_raster
    from physics_informed_image_segmentation_tpu_torch.utils import cuda_build

    bad = tmp_path / "rasterize.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_raster, "SOURCE", bad)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    native_raster._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as raised:
            rasterize_native([], (4, 4))
        assert "error" in str(raised.value)
        assert not native_available()
        assert not list((tmp_path / "build").glob("*.tmp"))
    finally:
        native_raster._load.cache_clear()
