"""Cell driver: Stage II training of TransUNet through the port's ``train_stage``.

:mod:`.train_stage`'s run with three things changed: the model is the
port's ``TransUNet`` at the configuration's widths, with the weights of
``reference/transunet.py::init_params`` drawn from the seed and fresh
BatchNorm statistics; the check replays the same steps in
``reference/transunet_steps.py`` (the BatchNorm buffers carried through);
and the window's ``work`` gives the readers the configuration's model
group and the attention's ``attention_counts`` over the window (``calls``
and query-key ``pairs``, with ``forwards``: the training and validation
forwards that made them).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset
from physics_informed_image_segmentation_tpu_torch.models import TransUNet
from physics_informed_image_segmentation_tpu_torch.train import (
    LossConfig, create_train_state, make_eval_epoch_fn, make_train_epoch_fn,
)

from .. import inputs
from ..reference import transunet, transunet_steps
from . import train_stage
from .train_stage import _Window, program_order

ARCH = ("hidden_size", "num_layers", "num_heads", "mlp_dim", "block_units", "width",
        "decoder_channels", "dropout", "in_channels")


class Run(train_stage.Run):
    def __init__(self, ctx):
        self.ctx = ctx
        model_cfg, tr = ctx.config["model"], ctx.traffic
        dev, size, b = ctx.device, ctx.config["image_size"], model_cfg["batch_size"]
        gen = inputs.generator(ctx.seed, 0, dev)
        images, masks = inputs.blobs(tr["train_images"] + tr["val_images"], size, gen, dev)
        nt = tr["train_images"]
        self.train = DeviceDataset(images[:nt], masks[:nt])
        self.val = DeviceDataset(images[nt:], masks[nt:])
        params0 = transunet.init_params(transunet.param_shapes(model_cfg, size), gen, dev)
        buffers0 = transunet.init_buffers(model_cfg, dev)
        with torch.device(dev):
            model = TransUNet(img_size=size, out_channels=model_cfg["n_classes"],
                              **{k: model_cfg[k] for k in ARCH})
        model.load_state_dict({**params0, **buffers0})
        self.params0 = {k: v.cpu() for k, v in params0.items()}
        self.buffers0 = {k: v.cpu() for k, v in buffers0.items()}
        del params0, buffers0
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

    def window(self, seconds: float, trace: bool) -> dict:
        tr, b = self.ctx.traffic, self.ctx.config["model"]["batch_size"]
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        counts = self.state.model.attention_counts
        counts.update(calls=0, pairs=0)
        stop = _Window(seconds, tr["trace_epochs"] if trace else None)

        def first_epoch(epoch, row):
            if epoch == 1:
                self.window_params = train_stage._host_params(self.state.model)

        self.window_rows = self._stage(self.train, self.window_seed, 10 ** 9, stop, first_epoch)
        epochs, span = len(stop.ends), stop.ends[-1] - stop.t0
        e2e = {"train_img_per_s": epochs * self.train.n / span}
        if self.ctx.device.type == "cuda":
            e2e["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        steps, val_batches = epochs * (self.train.n // b), epochs * (self.val.n // b)
        work = {"window_s": span, "train_steps": steps, "val_batches": val_batches, "batch": b,
                "size": self.ctx.config["image_size"], "model": self.ctx.config["model"],
                "attention_counts": dict(counts, forwards=steps + val_batches)}
        return {"e2e": e2e, "work": work, "attempted": epochs, "failed": 0}

    def _reference(self, quant=None, fault=None) -> dict:
        cfg, data = self.ctx.config, self.train
        b = cfg["model"]["batch_size"]
        window = program_order(data.n, self.window_seed).view(-1, b)
        epochs = [[r] for r in self.first_rows] + [list(window)]
        dev = data.images.device
        epochs = [[(data.images[r.to(dev)], data.masks[r.to(dev)]) for r in batches]
                  for batches in epochs]
        return transunet_steps.train_steps(
            self.params0, self.buffers0, epochs, (self.val.images, self.val.masks),
            cfg["model"], cfg["objective"], cfg["optimizer"], self.dropout_seed,
            split=len(self.first_rows), quant=quant, fault=fault)


def setup(ctx) -> Run:
    return Run(ctx)
