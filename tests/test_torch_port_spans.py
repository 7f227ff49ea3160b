"""PyTorch port: the program's spans (``utils/profiling.py::span``).

* With no profiler recording, a span is a shared no-op that never builds a
  record function.
* Under ``torch.profiler``, a two-epoch ``train_stage`` of two steps an
  epoch and a ``Predictor.predict`` of three chunks (the last padded, with
  a threshold) open each ``piis.*`` span the expected number of times,
  under the expected parent.
* Their outputs are bit-identical with and without the profiler.
* ``profiling.trace`` writes the spans into its Chrome trace.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset, make_blobs
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.serve import Predictor
from physics_informed_image_segmentation_tpu_torch.train import (
    LossConfig,
    create_train_state,
    make_eval_epoch_fn,
    make_train_epoch_fn,
    save_params,
)
from physics_informed_image_segmentation_tpu_torch.train.engine import train_stage
from physics_informed_image_segmentation_tpu_torch.utils import profiling

C, HW, BATCH = 4, 32, 4
PHYSICS = dict(pde_weight=1e-3, phase_field_weight=1e-4, diffusion_coeff=5.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests, the previous count after
    it: the suite runs several test processes side by side on one host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stage():
    """A fresh state through two epochs of two steps (8 training images,
    batch 4) and one validation batch each; returns (rows, parameters)."""
    images, masks = make_blobs(12, HW, HW, seed=4)
    train = DeviceDataset.from_numpy(images[:8], masks[:8], "cpu")
    val = DeviceDataset.from_numpy(images[8:], masks[8:], "cpu")
    model = UNet(base_channels=C, dropout=0.1, generator=torch.Generator().manual_seed(6))
    state = create_train_state(model, 1e-3, dropout_seed=8)
    cfg = LossConfig(**PHYSICS)
    state, _, _, rows = train_stage(state, make_train_epoch_fn(cfg), make_eval_epoch_fn(cfg),
                                    train, val, batch_size=BATCH, num_epochs=2,
                                    stage_name="Stage II", shuffle_seed=5, verbose=False)
    return rows, [p.detach().clone() for p in state.model.parameters()]


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans") / "unet.pth"
    save_params(UNet(base_channels=C, generator=torch.Generator().manual_seed(3)), path)
    return Predictor(path, batch_size=BATCH, image_size=(HW, HW), precision="f32",
                     base_channels=C, device="cpu")


def _images():
    return make_blobs(10, HW, HW, seed=9)[0]  # chunks of 4, 4 and 2 padded to 4


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _span_tree(prof) -> Counter:
    """(span, nearest enclosing span or None) -> count, over the trace."""
    tree = Counter()
    for ev in prof.events():
        if ev.name.startswith("piis."):
            parent = ev.cpu_parent
            while parent is not None and not parent.name.startswith("piis."):
                parent = parent.cpu_parent
            tree[(ev.name, parent.name if parent else None)] += 1
    return tree


def test_span_without_profiler_never_builds_a_record_function(monkeypatch, predictor):
    def refuse(name):
        raise AssertionError(f"record function built for {name} with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    first = profiling.span("piis.step")
    assert first is profiling.span("piis.predict")  # one shared no-op
    with first:
        pass
    _stage()
    predictor.predict(_images(), threshold=0.5)
    with profile(activities=[ProfilerActivity.CPU]):  # the patched name is what a span calls
        with pytest.raises(AssertionError, match="piis.step"):
            profiling.span("piis.step")


def test_train_stage_spans_nest_and_count():
    _, prof = _traced(_stage)
    epochs, steps, val_batches = 2, 2, 1
    assert _span_tree(prof) == Counter({
        ("piis.plan", None): 1,  # the validation plan, made once a stage
        ("piis.epoch", None): epochs,
        ("piis.plan", "piis.epoch"): epochs,
        ("piis.step", "piis.epoch"): epochs * steps,
        ("piis.forward", "piis.step"): epochs * steps,
        ("piis.objective", "piis.step"): epochs * steps,
        ("piis.backward", "piis.step"): epochs * steps,
        ("piis.optimizer", "piis.step"): epochs * steps,
        ("piis.metrics", "piis.step"): epochs * steps,
        ("piis.sync", "piis.epoch"): epochs,
        ("piis.val", "piis.epoch"): epochs,
        ("piis.forward", "piis.val"): epochs * val_batches,
        ("piis.objective", "piis.val"): epochs * val_batches,
        ("piis.metrics", "piis.val"): epochs * val_batches,
        ("piis.sync", "piis.val"): epochs,
        ("piis.log", "piis.epoch"): epochs,
    })
    assert {name for name, _ in _span_tree(prof)} <= set(profiling.SPANS)


def test_predict_spans_nest_and_count(predictor):
    masks, prof = _traced(lambda: predictor.predict(_images(), threshold=0.5))
    assert masks.shape == (10, HW, HW, 1)
    assert _span_tree(prof) == Counter({
        ("piis.predict", None): 1,
        ("piis.upload", "piis.predict"): 3,
        ("piis.forward", "piis.predict"): 3,
        ("piis.fetch", "piis.predict"): 4,  # one a chunk, and the last chunk's unpack
        ("piis.threshold", "piis.predict"): 3,
    })


@pytest.mark.parametrize("path", ["train_stage", "predict"])
def test_outputs_are_bit_identical_under_the_profiler(path, predictor):
    if path == "train_stage":
        (rows_a, params_a), (rows_b, params_b) = _stage(), _traced(_stage)[0]
        assert rows_a == rows_b
        assert all(torch.equal(a, b) for a, b in zip(params_a, params_b))
    else:
        plain = predictor.predict(_images())
        traced = _traced(lambda: predictor.predict(_images()))[0]
        assert np.array_equal(plain, traced)
        assert np.array_equal(predictor.predict(_images(), threshold=0.5),
                              _traced(lambda: predictor.predict(_images(), threshold=0.5))[0])


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path, predictor):
    with profiling.trace(tmp_path / "tr"):
        predictor.predict(_images(), threshold=0.5)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = Counter(e["name"] for e in events if e.get("name", "").startswith("piis."))
    assert names == Counter({"piis.predict": 1, "piis.upload": 3, "piis.forward": 3,
                             "piis.fetch": 4, "piis.threshold": 3})
