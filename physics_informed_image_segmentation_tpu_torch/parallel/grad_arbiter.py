"""How far float32 rounding alone moves the U-Net's gradients and trajectories.

    python -m physics_informed_image_segmentation_tpu_torch.parallel.grad_arbiter
    python -m physics_informed_image_segmentation_tpu_torch.parallel.grad_arbiter \
        --device cpu --size 64 --base-channels 4

Two measurements on :mod:`.spatial_check`'s data (``make_blobs`` seed 1,
the Stage II objective, seeded weights, dropout 0), in one process with no
process group, printed as one JSON line:

* ``arbiter``: the first batch's gradient (its last slot invalid) taken in
  float64 on the CPU, and against it, tensor by tensor (relative L2), the
  same gradient in float32 on ``device`` taken whole, one sample at a time
  through the band path's forward (explicit zero ghost rows and
  ``padding=(0, 1)`` convolutions, as a world-one mesh runs it), and in the
  shapes of a data 2 × space 2 mesh (two halves of the batch, each in two
  bands whose ghost rows hold the neighbouring band's rows).  Each with the
  library's convolutions (cuDNN; oneDNN on the CPU) and without them.  It
  tells a gradient that float32 cannot resolve from a path that computes
  a wrong one;
* ``self_gap``: :mod:`.spatial_check`'s unsharded stage run again from the
  same weights with only the convolutions' algorithms changed (cuDNN off,
  cuDNN's benchmark on; oneDNN off on the CPU): the largest parameter
  difference over the largest movement and the ratio of their L2 norms,
  the numbers :mod:`.spatial_check`'s parameter bar reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch
import torch.nn.functional as F

from ..data import DeviceDataset, make_blobs
from ..models import UNet
from ..train.engine import forward_nhwc, make_eval_epoch_fn, make_train_epoch_fn
from ..train.objective import make_loss_and_components
from ..utils.device import card_line, resolve_device, set_precision
from .spatial_check import STAGE2, _rel_l2, _stage, param_gap
from .spatial_unet import _unet, check_band_rows

__all__ = ["banded_forward_nhwc", "first_step_arbiter", "self_gap", "main"]

# the tensors that four-way splits move most on four H100s
WATCHED = ("enc4.conv.0.weight", "bottleneck.conv.0.weight", "bottleneck.conv.0.bias",
           "bottleneck.conv.2.weight")


def banded_forward_nhwc(model, x: torch.Tensor, bands: int) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, C_out) with every 3×3 convolution run on
    ``bands`` row bands of H / ``bands`` rows, each with a ghost row above
    and below (the neighbouring band's row, zero at the field's edges) and
    ``padding=(0, 1)``: the shapes and the numerics of the space-sharded
    forward, in one process."""
    check_band_rows(x.shape[1] // bands)

    def conv(m, h):
        p = F.pad(h, (0, 0, 1, 1))
        n = h.shape[2] // bands
        return torch.cat([F.conv2d(p[:, :, i * n:(i + 1) * n + 2], m.weight, m.bias,
                                   padding=(0, 1)) for i in range(bands)], dim=2)

    out = _unet(model, x.permute(0, 3, 1, 2), None, (x.shape[0], 0), conv)
    return out.permute(0, 2, 3, 1)


def _algorithms(device: torch.device, name: str):
    """The convolutions' algorithms: ``"library"`` (cuDNN, deterministic, no
    benchmark; oneDNN on the CPU), ``"plain"`` (PyTorch's own kernels) or
    ``"benchmark"`` (cuDNN's fastest deterministic algorithm)."""
    if device.type == "cpu":
        if name == "benchmark":
            raise ValueError("'benchmark' picks cuDNN's algorithms: it needs a CUDA device")
        return torch.backends.mkldnn.flags(enabled=name == "library")
    return torch.backends.cudnn.flags(enabled=name != "plain", benchmark=name == "benchmark",
                                      deterministic=True, allow_tf32=False)


def _data(size: int, n_train: int, n_val: int, device):
    images, masks = make_blobs(n_train + n_val, size, size, seed=1)
    return (DeviceDataset.from_numpy(images[:n_train], masks[:n_train], device),
            DeviceDataset.from_numpy(images[n_train:], masks[n_train:], device))


def _fresh(base_channels: int, device, dtype=torch.float32):
    return UNet(base_channels=base_channels, dropout=0.0,
                generator=torch.Generator().manual_seed(0)).to(device=device, dtype=dtype)


def first_step_arbiter(size: int = 128, base_channels: int = 64, batch: int = 4,
                       device=None) -> dict:
    """The first batch's gradient in float32 on ``device`` by each path,
    against the float64 gradient on the CPU (see the module docstring).
    Returns, for each ``{path}_{algorithms}``, the largest relative L2
    difference, its tensor, the four largest and those of :data:`WATCHED`;
    and ``vs_whole``: each path against the float32 whole-batch gradient
    with the library's algorithms, as :mod:`.spatial_check` reads it."""
    dev = resolve_device(device)
    set_precision("f32")
    train, _ = _data(size, batch, 0, dev)
    x, y = train.images[:batch], train.masks[:batch]
    valid = torch.ones(batch, device=dev)
    valid[-1] = 0.0
    mask = valid.reshape(-1, 1, 1, 1)

    def grad(model, pred, yy, mm, cfg):
        loss = make_loss_and_components(cfg)(pred, yy, mm)[0]
        return torch.autograd.grad(loss, list(model.parameters()))

    ref_model = _fresh(base_channels, "cpu", torch.float64)
    names = [n for n, _ in ref_model.named_parameters()]
    g64 = grad(ref_model, forward_nhwc(ref_model, x.cpu().double(), "f32"), y.cpu().double(),
               mask.cpu().double(), dataclasses.replace(STAGE2, backend="torch"))

    paths = {
        "whole": lambda m: forward_nhwc(m, x, "f32"),
        "per_sample_band_path": lambda m: torch.cat(
            [banded_forward_nhwc(m, xs, 1) for xs in x.chunk(batch)]),
        "data2_space2_bands": lambda m: torch.cat(
            [banded_forward_nhwc(m, xs, 2) for xs in x.chunk(2)]),
    }
    grads = {}
    for algorithms in ("library", "plain"):
        for path, forward in paths.items():
            with _algorithms(dev, algorithms):
                model = _fresh(base_channels, dev)
                grads[f"{path}_{algorithms}"] = [
                    g.double().cpu() for g in grad(model, forward(model), y, mask, STAGE2)]

    def summary(rel):
        by_name = {n: r for r, n in rel}
        return {"max_rel_l2": rel[0][0], "worst": rel[0][1], "top": rel[:4],
                "watched": {n: by_name[n] for n in WATCHED if n in by_name}}

    out = {k: summary(_rel_l2(g, g64, names)) for k, g in grads.items()}
    whole = grads["whole_library"]
    out["vs_whole"] = {k: summary(_rel_l2(g, whole, names))
                       for k, g in grads.items() if k != "whole_library"}
    return out


def self_gap(size: int = 128, base_channels: int = 64, batch: int = 4, n_train: int = 6,
             n_val: int = 3, device=None) -> dict:
    """:mod:`.spatial_check`'s unsharded stage with the library's
    convolution algorithms, against itself with other algorithms (see the
    module docstring): ``{algorithms: {max_abs_dparam, movement, ratio,
    dparam_l2_over_movement_l2}}``."""
    dev = resolve_device(device)
    set_precision("f32")
    train, val = _data(size, n_train, n_val, dev)
    fns = (make_train_epoch_fn(STAGE2), make_eval_epoch_fn(STAGE2))
    start = [p.detach().clone() for p in _fresh(base_channels, dev).parameters()]
    runs = {}
    others = ("plain",) if dev.type == "cpu" else ("plain", "benchmark")
    for algorithms in ("library", *others):
        with _algorithms(dev, algorithms):
            runs[algorithms] = _fresh(base_channels, dev)
            _stage(runs[algorithms], fns, train, val, batch, 1)
    out = {}
    for algorithms in others:
        gap, move, l2 = param_gap(runs[algorithms], runs["library"], start)
        out[algorithms] = {"max_abs_dparam": gap, "movement": move, "ratio": gap / move,
                           "dparam_l2_over_movement_l2": l2}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--base-channels", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    common = dict(size=args.size, base_channels=args.base_channels, batch=args.batch,
                  device=args.device)
    res = {"image": [args.size, args.size], "base_channels": args.base_channels,
           "batch": args.batch, "arbiter": first_step_arbiter(**common),
           "self_gap": self_gap(**common)}
    dev = resolve_device(args.device)
    res["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        res["card"] = card_line()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
