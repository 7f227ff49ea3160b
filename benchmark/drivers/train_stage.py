"""Cell driver: Stage II training through the port's ``train_stage``.

Set-up builds one train state (the U-Net with the seed's weights, a fresh
optimizer, the dropout generator) and drives it through the traffic's
first steps: ``first_steps`` calls of ``train_stage`` of one epoch each,
each epoch one batch of rows that no other step sees, each followed by
its validation pass.  They build the kernels, choose cuDNN's algorithms
and warm every shape the window uses.  The window hands the same state
to one ``train_stage`` call over the whole split, which stops at the
first epoch's end after ``--seconds`` (or after ``trace_epochs`` epochs
in a traced run): ``train_img_per_s`` is the training images of those
epochs over their time, validation included, and ``train_peak_gib`` the
peak of allocated memory in the window.  At the window's first epoch's
end its parameters are copied to the host.

The check replays, in the plain reference, the first steps and then the
window's first epoch (all its steps, in its shuffled order, and its
validation pass) from the same weights, rows and dropout seed, and
compares the first steps' losses and metrics, the first gradient's leaf
norms (from the optimizer's first moment after one step: m = (1 - b1) g)
and those of the parameters' change over the first steps and over the
window's first epoch (:func:`..compare.train_numbers`).
"""

from __future__ import annotations

import gc
import os
import time
from pathlib import Path

import numpy as np
import torch

from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset
from physics_informed_image_segmentation_tpu_torch.models import UNet
from physics_informed_image_segmentation_tpu_torch.train import (
    LossConfig, create_train_state, make_eval_epoch_fn, make_train_epoch_fn,
)
from physics_informed_image_segmentation_tpu_torch.train.engine import train_stage

from .. import inputs
from ..compare import train_numbers
from ..reference.steps import train_steps

B1 = 0.9  # optax's first-moment decay: the program's m after one step is (1 - B1) g


class _Window:
    """``train_stage``'s ``early_stopping``: stops at an epoch's end once
    the window's time (or its number of epochs) is reached, and records
    when each epoch ended."""

    def __init__(self, seconds: float, epochs: int | None):
        self.seconds, self.epochs = seconds, epochs
        self.t0 = time.perf_counter()
        self.ends: list[float] = []

    def __call__(self, score: float, epoch: int) -> bool:
        self.ends.append(time.perf_counter())
        if self.epochs is not None:
            return len(self.ends) >= self.epochs
        return self.ends[-1] - self.t0 >= self.seconds


def program_order(n: int, shuffle_seed: int) -> torch.Tensor:
    """The row order of the first epoch of ``train_stage``: ``torch.randperm``
    from a CPU generator seeded by SeedSequence(shuffle_seed, 0), as its
    docstring states."""
    s = int(np.random.SeedSequence([int(shuffle_seed), 0]).generate_state(1)[0])
    return torch.randperm(n, generator=torch.Generator().manual_seed(s))


def _host_params(model) -> dict:
    with torch.no_grad():
        return {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        model_cfg, tr = ctx.config["model"], ctx.traffic
        dev, size, b = ctx.device, ctx.config["image_size"], model_cfg["batch_size"]
        gen = inputs.generator(ctx.seed, 0, dev)
        images, masks = inputs.blobs(tr["train_images"] + tr["val_images"], size, gen, dev)
        nt = tr["train_images"]
        self.train = DeviceDataset(images[:nt], masks[:nt])
        self.val = DeviceDataset(images[nt:], masks[nt:])
        params0 = inputs.weights(model_cfg, gen, dev)
        model = UNet(in_channels=model_cfg["in_channels"], out_channels=model_cfg["out_channels"],
                     base_channels=model_cfg["base_channels"], dropout=model_cfg["dropout"],
                     intermediate_activation=model_cfg["activation"]).to(dev)
        model.load_state_dict(params0)
        self.params0 = {k: v.cpu() for k, v in params0.items()}
        del params0
        opt = ctx.config["optimizer"]
        self.dropout_seed = inputs.derive(ctx.seed, 1)
        self.window_seed = inputs.derive(ctx.seed, 2)
        self.state = create_train_state(model, opt["learning_rate"], opt["weight_decay"],
                                        optimizer=opt["name"], dropout_seed=self.dropout_seed)
        self.names = [k for k, _ in model.named_parameters()]
        loss_cfg = LossConfig(**ctx.config["objective"])
        precision = ctx.config["precision"]
        self.train_fn = make_train_epoch_fn(loss_cfg, precision=precision)
        self.eval_fn = make_eval_epoch_fn(loss_cfg, precision=precision)
        self.csv = Path(os.environ.get("TMPDIR", "/tmp")) / f"bench_{ctx.cell}_stage2.csv"
        self.first = self._first_steps(tr["first_steps"], b)

    def _stage(self, train, shuffle_seed, num_epochs, early_stopping=None, epoch_callback=None):
        return train_stage(
            self.state, self.train_fn, self.eval_fn, train, self.val,
            batch_size=self.ctx.config["model"]["batch_size"], num_epochs=num_epochs,
            stage_name="Stage II", shuffle_seed=shuffle_seed, early_stopping=early_stopping,
            verbose=False, csv_path=self.csv, epoch_callback=epoch_callback)[3]

    def _first_steps(self, steps: int, b: int) -> dict:
        rows, self.first_rows = [], []
        grads = None
        for k in range(steps):
            seed_k = inputs.derive(self.ctx.seed, 10 + k)
            rows += self._stage(DeviceDataset(self.train.images[k * b:(k + 1) * b],
                                                   self.train.masks[k * b:(k + 1) * b]),
                                seed_k, 1)
            self.first_rows.append(k * b + program_order(b, seed_k))
            if k == 0:
                m = self.state.optimizer.state_dict()["m"]
                if len(m) != len(self.names):
                    raise RuntimeError("the optimizer's state has no first moment per parameter")
                grads = {n: t.detach().cpu() / (1.0 - B1) for n, t in zip(self.names, m)}
        self.params_setup = _host_params(self.state.model)
        return {"rows": rows, "grads": grads,
                "changes": {n: p - self.params0[n] for n, p in self.params_setup.items()}}

    def window(self, seconds: float, trace: bool) -> dict:
        tr, b = self.ctx.traffic, self.ctx.config["model"]["batch_size"]
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        stop = _Window(seconds, tr["trace_epochs"] if trace else None)

        def first_epoch(epoch, row):
            if epoch == 1:
                self.window_params = _host_params(self.state.model)

        self.window_rows = self._stage(self.train, self.window_seed, 10 ** 9, stop, first_epoch)
        epochs, span = len(stop.ends), stop.ends[-1] - stop.t0
        e2e = {"train_img_per_s": epochs * self.train.n / span}
        if self.ctx.device.type == "cuda":
            e2e["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        work = {"window_s": span, "train_steps": epochs * (self.train.n // b),
                "val_batches": epochs * (self.val.n // b), "batch": b,
                "size": self.ctx.config["image_size"],
                "base": self.ctx.config["model"]["base_channels"]}
        return {"e2e": e2e, "work": work, "attempted": epochs, "failed": 0}

    def release(self) -> None:
        """Free the program's state: the reference runs after it."""
        del self.state, self.train_fn, self.eval_fn
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, quant=None, fault=None) -> dict:
        cfg, data = self.ctx.config, self.train
        b = cfg["model"]["batch_size"]
        window = program_order(data.n, self.window_seed).view(-1, b)
        epochs = [[r] for r in self.first_rows] + [list(window)]
        epochs = [[(data.images[r.to(data.images.device)], data.masks[r.to(data.images.device)])
                   for r in batches] for batches in epochs]
        return train_steps(self.params0, epochs, (self.val.images, self.val.masks),
                           cfg["model"], cfg["objective"], cfg["optimizer"], self.dropout_seed,
                           split=len(self.first_rows), quant=quant, fault=fault)

    def program(self) -> dict:
        """The program's readings: the set-up's rows, first gradient and
        change, then the window's first epoch's row and change."""
        return dict(self.first, window_rows=self.window_rows[:1],
                    window_changes={n: p - self.params_setup[n]
                                    for n, p in self.window_params.items()})

    def check(self) -> dict:
        self.ref = self._reference()
        return train_numbers(self.program(), self.ref)

    def planted(self, kind: str) -> dict:
        """The reference put in the program's place: ``"fp8"`` computes it
        with fp8 convolutions (the precision below the configuration's
        bf16); ``"half"``, ``"bf1"`` and ``"repeat"`` plant a fault
        (:func:`..reference.steps.train_steps`)."""
        return self._reference(quant="fp8") if kind == "fp8" else self._reference(fault=kind)

    def control(self, kind: str) -> dict:
        """The numbers of :meth:`planted` ``kind``.  After :meth:`check`."""
        return train_numbers(self.planted(kind), self.ref)


def setup(ctx) -> Run:
    return Run(ctx)
