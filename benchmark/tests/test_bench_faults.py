"""A whole run, the look for a card skipped, with the timed path broken
underneath: ``correct`` comes out false for each fault a cell can have
(a step that leaves its state unchanged, also only from the window's
first step on, half of the batch left out, an answer altered where it is
produced), and true without one."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run as R
from physics_informed_image_segmentation_tpu_torch.serve import Predictor
from physics_informed_image_segmentation_tpu_torch.train import engine, optim

from .tiny import make_root


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, cell):
    spec = R.load_cell(cell, make_root(tmp_path))
    return R.run_cell(spec, 2 ** 31 + 99, 1.0, False, "cpu", time.perf_counter())


def _unchanged(monkeypatch):
    def step(self, grads):
        self.count += 1  # the step is counted, and nothing moves
    monkeypatch.setattr(optim.AdamW, "step", step)


def _unchanged_in_the_window(monkeypatch):
    step = optim.AdamW.step

    def after_setup(self, grads):
        if self.count < 3:  # the set-up's three steps move; the window's do not
            return step(self, grads)
        self.count += 1
    monkeypatch.setattr(optim.AdamW, "step", after_setup)


def _half_batch(monkeypatch):
    make = engine.make_loss_and_components

    def halved(cfg, *a, **k):
        loss = make(cfg, *a, **k)

        def fn(pred, target, mask=None):
            h = pred.shape[0] // 2
            return loss(pred[:h], target[:h], None if mask is None else mask[:h])
        return fn
    monkeypatch.setattr(engine, "make_loss_and_components", halved)


def _gradient_altered(monkeypatch):
    step = optim.AdamW.step

    def doubled(self, grads):
        grads = list(grads)
        grads[0] = 2 * grads[0]
        return step(self, grads)
    monkeypatch.setattr(optim.AdamW, "step", doubled)


def _mask_altered(monkeypatch):
    predict = Predictor.predict

    def flipped(self, images, threshold=None, tta=False):
        out = predict(self, images, threshold, tta)
        out[0] = 1.0 - out[0]
        return out
    monkeypatch.setattr(Predictor, "predict", flipped)


def _chunk_halved(monkeypatch):
    forward = Predictor._forward

    def halved(self, x):
        out = forward(self, x).clone()
        out[x.shape[0] // 2:] = 0.0
        return out
    monkeypatch.setattr(Predictor, "_forward", halved)


@pytest.mark.parametrize("cell, fault", [
    ("tiny-train", None), ("tiny-train", _unchanged), ("tiny-train", _unchanged_in_the_window),
    ("tiny-train", _half_batch),
    ("tiny-train", _gradient_altered),
    ("tiny-predict", None), ("tiny-predict", _mask_altered), ("tiny-predict", _chunk_halved),
])
def test_a_fault_underneath_makes_the_run_incorrect(tmp_path, monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch)
    result = _run(tmp_path, cell)
    assert result["correct"] is (fault is None), result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}
