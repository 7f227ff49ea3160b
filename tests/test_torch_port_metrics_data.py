"""PyTorch port: metrics, statistics report, data pipeline, synthetic data,
COCO decoding and the CSV schema, held against the JAX package.

Metrics on binary masks are exact in both frameworks (sums of 0/1 values
in float32), so they must agree bit for bit.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.data import coco as jax_coco
from physics_informed_image_segmentation_tpu.data import pipeline as jax_pipeline
from physics_informed_image_segmentation_tpu.data import synthetic as jax_synthetic
from physics_informed_image_segmentation_tpu.ops import metrics as jax_metrics
from physics_informed_image_segmentation_tpu.ops import stats as jax_stats
from physics_informed_image_segmentation_tpu.train import csvlog as jax_csvlog
from physics_informed_image_segmentation_tpu_torch.data import (
    CocoSegmentationSource,
    DeviceDataset,
    epoch_batch_indices,
    make_blobs,
    num_batches,
    subset_fraction_indices,
    write_synthetic_coco,
)
from physics_informed_image_segmentation_tpu_torch.ops import metrics, stats
from physics_informed_image_segmentation_tpu_torch.train import csvlog


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _masks(seed, shape=(4, 24, 24)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(size=shape).astype(np.float32)
    _, target = make_blobs(shape[0], shape[1], shape[2], seed=seed)
    return pred, target[..., 0]


@pytest.mark.parametrize("name", ["dice_score", "iou_score", "dice_score_per_sample",
                                  "iou_score_per_sample", "boundary_f1_per_sample"])
def test_metrics_bit_equal(name):
    pred, target = _masks(0)
    ours = getattr(metrics, name)(torch.tensor(pred), torch.tensor(target)).numpy()
    ref = np.asarray(getattr(jax_metrics, name)(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("tolerance", [0, 1, 3])
def test_boundary_f1_tolerances_bit_equal(tolerance):
    pred, target = _masks(1)
    ours = metrics.boundary_f1_per_sample(torch.tensor(pred), torch.tensor(target),
                                          tolerance=tolerance).numpy()
    ref = np.asarray(jax_metrics.boundary_f1_per_sample(
        jnp.asarray(pred), jnp.asarray(target), tolerance=tolerance))
    np.testing.assert_array_equal(ours, ref)


def test_masked_global_metrics_bit_equal():
    pred, target = _masks(2)
    mask = np.array([1, 0, 1, 1], np.float32).reshape(4, 1, 1)
    for name in ("dice_score", "iou_score"):
        ours = getattr(metrics, name)(torch.tensor(pred), torch.tensor(target),
                                      mask=torch.tensor(mask))
        ref = getattr(jax_metrics, name)(jnp.asarray(pred), jnp.asarray(target),
                                         mask=jnp.asarray(mask))
        assert float(ours) == float(ref), name


def test_boundaries_and_hausdorff_equal():
    pred, target = _masks(3)
    pb = (pred > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        metrics.extract_boundaries(torch.tensor(target)).numpy(),
        np.asarray(jax_metrics.extract_boundaries(jnp.asarray(target))))
    for i in range(pred.shape[0]):
        assert metrics.hausdorff_distance_np(pb[i], target[i]) == \
            jax_metrics.hausdorff_distance_np(pb[i], target[i])
    assert metrics.hausdorff_distance_np(np.zeros((8, 8)), target[0, :8, :8]) == float("inf")


def test_metric_report_and_statistics_equal():
    arrays = {"dice_scores": np.array([0.5, np.nan, 0.7]), "hausdorff_distances": np.array([])}
    assert stats.format_metric_report(arrays, "M") == jax_stats.format_metric_report(arrays, "M")
    assert stats.compute_statistics([1.0, 2.0]) == jax_stats.compute_statistics([1.0, 2.0])


def test_csv_header_byte_equal(tmp_path):
    assert csvlog.EPOCH_CSV_FIELDS == jax_csvlog.EPOCH_CSV_FIELDS
    row = {k: float(i) for i, k in enumerate(csvlog.EPOCH_CSV_FIELDS)}
    csvlog.save_metrics_to_csv([row], tmp_path / "a.csv")
    jax_csvlog.save_metrics_to_csv([row], tmp_path / "b.csv")
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    test_metrics = {"dice_scores": np.array([0.5, 0.6]), "hausdorff_distances": np.array([np.nan, 2.0])}
    csvlog.save_test_metrics(test_metrics, tmp_path / "t1")
    jax_csvlog.save_test_metrics(test_metrics, tmp_path / "t2")
    for suffix in (".csv", ".json"):
        assert (tmp_path / f"t1{suffix}").read_bytes() == (tmp_path / f"t2{suffix}").read_bytes()


def test_make_blobs_equal():
    for a, b in zip(make_blobs(3, 20, 24, seed=5), jax_synthetic.make_blobs(3, 20, 24, seed=5)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_coco_decodes_like_jax(tmp_path):
    img_dir, ann = write_synthetic_coco(tmp_path / "port", n=3, missing_files=1, seed=2)
    jimg_dir, jann = jax_synthetic.write_synthetic_coco(tmp_path / "jax", n=3, missing_files=1,
                                                        seed=2)
    assert json.loads(ann.read_text()) == json.loads(jann.read_text())
    ours = CocoSegmentationSource(img_dir, ann, (32, 40))
    ref = jax_coco.CocoSegmentationSource(jimg_dir, jann, (32, 40))
    assert ours.image_ids == ref.image_ids and len(ours) == 3
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.masks, ref.masks)


def test_subset_fraction_indices_equal():
    np.random.seed(11)
    ours = subset_fraction_indices(50, 0.3)
    np.random.seed(11)
    ref = jax_pipeline.subset_fraction_indices(50, 0.3)
    np.testing.assert_array_equal(ours, ref)
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    np.testing.assert_array_equal(subset_fraction_indices(9, 0.5, rng_a),
                                  jax_pipeline.subset_fraction_indices(9, 0.5, rng_b))


@pytest.mark.parametrize("n,batch", [(10, 4), (8, 8), (3, 5)])
def test_epoch_plan_layout(n, batch):
    idx, valid = epoch_batch_indices(n, batch, shuffle=False)
    jidx, jvalid = jax_pipeline.epoch_batch_indices(n, batch, shuffle=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert num_batches(n, batch) == idx.shape[0]
    sidx, svalid = epoch_batch_indices(n, batch, shuffle=True,
                                       generator=torch.Generator().manual_seed(0))
    assert sorted(sidx.reshape(-1)[svalid.reshape(-1) > 0].tolist()) == list(range(n))
    again, _ = epoch_batch_indices(n, batch, shuffle=True,
                                   generator=torch.Generator().manual_seed(0))
    assert torch.equal(sidx, again)


def test_device_dataset():
    images, masks = make_blobs(5, 8, 8, seed=0)
    data = DeviceDataset.from_numpy(images, masks, "cpu")
    assert data.n == 5 and data.images.dtype == torch.float32
    sub = data.select(np.array([4, 1]))
    np.testing.assert_array_equal(sub.masks.numpy(), masks[[4, 1]])
