"""PyTorch port: ``scripts/stream_train.py`` (the counterpart of the JAX
repo's ``scripts/stream_train_tpu.py``) on the CPU at a small size.

* Every row at base 4, 32x32, 20 images (a ragged last batch of 4, and a
  last chunk of 16 with 13 padding batches) counts exactly the real samples
  that the JAX package's pipeline gives on the same ``HostDataset``: the
  ``valid`` sum of JAX ``epoch_batch_indices`` plans for the resident row,
  of JAX ``batch_iterator`` batches for ``stream-step`` and of JAX
  ``chunk_batches`` chunks for ``stream-chunk-16``, over the same epochs and
  seeds.  Every rate is finite and positive, and each line has its keys.
* One row alone prints one line; an unknown row raises.
"""

import json

import jax
import numpy as np
import pytest
import torch

from physics_informed_image_segmentation_tpu.data import epoch_batch_indices as jax_plan
from physics_informed_image_segmentation_tpu.data import streaming as jax_streaming
from physics_informed_image_segmentation_tpu_torch.data import make_blobs
from physics_informed_image_segmentation_tpu_torch.scripts import stream_train

N, SIZE = 20, 32
TINY = ["--device", "cpu", "--base-channels", "4", "--size", str(SIZE), "--images", str(N),
        "--precision", "f32", "--rounds", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _lines(capsys, argv) -> list:
    assert stream_train.main(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def _jax_counts() -> dict:
    """Real samples a timed round of each row feeds, by the JAX pipeline."""
    images, masks = make_blobs(N, SIZE, SIZE, seed=0)
    host = jax_streaming.HostDataset(n=N, images=images, masks=masks)
    batch, k = stream_train.BATCH, stream_train.CHUNK_K
    timed = {row: e for row, (_, e) in stream_train.EPOCHS.items()}
    resident = sum(float(np.sum(jax_plan(N, batch, shuffle=True, key=jax.random.key(e))[1]))
                   for e in range(timed["resident"]))
    step = sum(float(np.sum(v)) for e in range(timed["stream-step"])
               for _, _, v in jax_streaming.batch_iterator(host, batch, shuffle=True, seed=e))
    chunk_row = stream_train.ROWS[2]
    chunk = sum(float(np.sum(vs)) for e in range(timed[chunk_row])
                for _, _, vs in jax_streaming.chunk_batches(
                    jax_streaming.batch_iterator(host, batch, shuffle=True, seed=e), k))
    return {"resident": resident, "stream-step": step, chunk_row: chunk}


def test_rows_count_the_jax_pipelines_real_samples(capsys):
    lines = _lines(capsys, TINY)
    assert [ln["row"] for ln in lines] == list(stream_train.ROWS)
    expected = _jax_counts()
    for ln in lines:
        assert ln["images_a_round"] == [expected[ln["row"]]], ln["row"]
        assert all(np.isfinite(r) and r > 0 for r in ln["rounds"]), ln
        assert ln["value"] == ln["rounds"][0]
        assert ln["timed_epochs"] == stream_train.EPOCHS[ln["row"]][1]
        assert ln["max_memory_allocated_bytes"] is None and ln["device_kind"] == "cpu"
        assert set(ln["k1_launches_per_step"]) == {"physics_sums_fwd", "physics_sums_bwd"}
    # the padding is real here: 3 batches an epoch, the last with 4 samples
    assert expected["stream-step"] == 2 * N


def test_one_row_alone_and_an_unknown_row(capsys):
    (line,) = _lines(capsys, ["stream-step", *TINY])
    assert line["row"] == "stream-step" and line["prefetch"] == 4
    with pytest.raises(ValueError, match="unknown rows"):
        stream_train.run_rows(("resident", "stream-chunk-8"), "cpu", n_images=N, size=SIZE,
                              base_channels=4, precision="f32")
