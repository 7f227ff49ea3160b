"""Cell driver: batch segmentation through the port's ``Predictor.predict``.

Set-up makes the seed's weights, writes them as the ``.pth`` a user
serves from (under ``$TMPDIR``), builds ``Predictor(batch_size=...)`` from
it, makes the host pool of images, and warms the one chunk shape.  The
window is a closed loop of one client, as ``predict.py`` is run over a
directory after another: each request is ``request_images`` images (one
directory's worth, the traffic's ``source``), a slice of the pool whose
start the seed draws, sent to ``predict(images, threshold)``; its latency
is the host time from the call to the masks returned.  The loop sends
requests until ``--seconds`` have passed (or, in a traced run,
``pass_requests`` of them), and waits for the last: ``predict_img_per_s``
is the images of all requests over that time, ``predict_p95_ms`` the 95th
percentile of all their latencies.

The check takes the masks of ``check_requests`` of the first
``pass_requests`` requests, drawn from the seed, and compares each with
the reference's float32 logits of the same images
(:func:`..compare.mask_gap`).
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from physics_informed_image_segmentation_tpu_torch.serve import Predictor

from .. import inputs
from ..compare import mask_gap
from ..reference.steps import logits


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        size = cfg["image_size"]
        gen = inputs.generator(ctx.seed, 0, dev)
        pool, _ = inputs.blobs(tr["pool_images"], size, gen, dev)
        self.pool = pool.cpu().numpy()
        del pool
        params = inputs.weights(cfg["model"], gen, dev)
        self.params = {k: v.cpu() for k, v in params.items()}
        del params
        path = Path(os.environ.get("TMPDIR", "/tmp")) / f"bench_{ctx.cell}.pth"
        torch.save(self.params, path)
        m = cfg["model"]
        self.predictor = Predictor(path, batch_size=tr["predictor_batch"], image_size=(size, size),
                                   precision=cfg["precision"], base_channels=m["base_channels"],
                                   device=dev)
        path.unlink()
        self.rng = np.random.default_rng(inputs.derive(ctx.seed, 1))
        self.sample = {int(i) for i in self.rng.choice(tr["pass_requests"], tr["check_requests"],
                                                       replace=False)}
        for _ in range(2):  # the one chunk shape: cuDNN's choice, the first launches
            self.predictor.predict(self.pool[: tr["predictor_batch"]], threshold=tr["threshold"])

    def window(self, seconds: float, trace: bool) -> dict:
        tr = self.ctx.traffic
        lat, images, failed, self.kept = [], 0, 0, []
        n, sent = tr["request_images"], 0
        t0 = time.perf_counter()
        while (sent < tr["pass_requests"]) if trace else (time.perf_counter() - t0 < seconds):
            start, i = int(self.rng.integers(0, self.pool.shape[0] - n + 1)), sent
            sent += 1
            t = time.perf_counter()
            try:
                masks = self.predictor.predict(self.pool[start:start + n],
                                               threshold=tr["threshold"])
            except RuntimeError:
                failed += 1
                continue
            lat.append(time.perf_counter() - t)
            images += n
            if i in self.sample:
                self.kept.append((start, n, masks))
        span = time.perf_counter() - t0
        e2e = {"predict_img_per_s": images / span,
               "predict_p95_ms": 1e3 * statistics.quantiles(lat, n=20)[-1]}
        work = {"window_s": span, "images": images, "requests": len(lat),
                "size": self.ctx.config["image_size"],
                "base": self.ctx.config["model"]["base_channels"]}
        return {"e2e": e2e, "work": work, "attempted": len(lat) + failed, "failed": failed}

    def release(self) -> None:
        del self.predictor
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _logits(self, start, n, quant=None):
        imgs = torch.from_numpy(self.pool[start:start + n]).to(self.ctx.device)
        params = {k: v.to(self.ctx.device) for k, v in self.params.items()}
        return logits(params, imgs, self.ctx.config["model"], self.ctx.traffic["check_block"],
                      quant=quant)

    def check(self) -> dict:
        if len(self.kept) < len(self.sample):
            return {"mask_gap": math.inf}  # a sampled request never came back
        gap = 0.0
        for start, n, masks in self.kept:
            ref = self._logits(start, n)
            gap = max(gap, mask_gap(torch.from_numpy(masks[..., 0]).to(ref.device), ref))
        return {"mask_gap": gap}

    def control(self, kind: str) -> dict:
        """The reference in fp8 put in the program's place.  After :meth:`check`."""
        if kind != "fp8":
            raise ValueError(f"no control {kind!r} for a serving cell")
        gap = 0.0
        for start, n, _ in self.kept:
            ref = self._logits(start, n)
            low = (self._logits(start, n, quant="fp8") > 0).float()
            gap = max(gap, mask_gap(low, ref))
        return {"mask_gap": gap}


def setup(ctx) -> Run:
    return Run(ctx)
