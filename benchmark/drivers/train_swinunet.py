"""Cell driver: Stage II training of Swin-Unet through the port's ``train_stage``.

:mod:`.train_transunet`'s run with the model changed: the port's
``SwinUnet`` at the configuration's widths, with the weights of
``reference/swin_unet.py::init_params`` drawn from the seed; the check
replays the same steps in ``reference/swinunet_steps.py``; and the
window's ``work`` gives the readers, beside the configuration's model
group and ``attention_counts``, the model's ``window_counts`` over the
window (``windows`` attended and ``shifted`` calls).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from physics_informed_image_segmentation_tpu_torch.data import DeviceDataset
from physics_informed_image_segmentation_tpu_torch.models import SwinUnet
from physics_informed_image_segmentation_tpu_torch.train import (
    LossConfig, create_train_state, make_eval_epoch_fn, make_train_epoch_fn,
)

from .. import inputs
from ..reference import swin_unet, swinunet_steps
from . import train_transunet
from .train_stage import program_order

ARCH = ("embed_dim", "depths", "num_heads", "window_size", "patch_size", "mlp_ratio",
        "drop_path_rate", "in_channels")


class Run(train_transunet.Run):
    def __init__(self, ctx):
        self.ctx = ctx
        model_cfg, tr = ctx.config["model"], ctx.traffic
        dev, size, b = ctx.device, ctx.config["image_size"], model_cfg["batch_size"]
        gen = inputs.generator(ctx.seed, 0, dev)
        images, masks = inputs.blobs(tr["train_images"] + tr["val_images"], size, gen, dev)
        nt = tr["train_images"]
        self.train = DeviceDataset(images[:nt], masks[:nt])
        self.val = DeviceDataset(images[nt:], masks[nt:])
        params0 = swin_unet.init_params(swin_unet.param_shapes(model_cfg, size), gen, dev)
        with torch.device(dev):
            model = SwinUnet(img_size=size, out_channels=model_cfg["n_classes"],
                             **{k: model_cfg[k] for k in ARCH})
        model.load_state_dict(params0, strict=False)  # the buffers are the model's own
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

    def window(self, seconds: float, trace: bool) -> dict:
        counts = self.state.model.window_counts
        counts.update(windows=0, shifted=0)
        out = super().window(seconds, trace)
        out["work"]["window_counts"] = dict(counts)
        return out

    def _reference(self, quant=None, fault=None) -> dict:
        cfg, data = self.ctx.config, self.train
        b = cfg["model"]["batch_size"]
        window = program_order(data.n, self.window_seed).view(-1, b)
        epochs = [[r] for r in self.first_rows] + [list(window)]
        dev = data.images.device
        epochs = [[(data.images[r.to(dev)], data.masks[r.to(dev)]) for r in batches]
                  for batches in epochs]
        return swinunet_steps.train_steps(
            self.params0, epochs, (self.val.images, self.val.masks), cfg["model"],
            cfg["objective"], cfg["optimizer"], self.dropout_seed, split=len(self.first_rows),
            quant=quant, fault=fault)


def setup(ctx) -> Run:
    return Run(ctx)
