"""A/B turns of the headline bench's training program inside one process.

Counterpart of the JAX repo's ``scripts/ab_bench.py``.  Every variant is
the workload of :mod:`..bench` (base 64, batch 8, 128x128, bf16, Stage II
objective with K1, on-device metrics) with one or more settings changed.
Each variant gets its own model from the same seed; all are built and
warmed up first, then timed in turns (A B, B A, A B, ...), ``--rounds``
timed calls each, every call between two synchronisations.  One line per
variant (median img/s, every round, launches per step), then one line of
each variant's ratio to the first: the median of the turn-by-turn ratios
and their min and max.

A variant is a word of ``key=value`` settings joined by commas, or a bare
optimizer name:

    opt=NAME     a ``create_train_state`` optimizer: adamw, flat_adamw,
                 grouped_adamw, pallas_adamw (K2), bf16m_adamw, bf16mv_adamw
    flat=0|1     ``create_train_state(flat=...)``: the parameters as views
                 of one buffer
    bs=N         batch size
    calls=epochs|epoch
                 E epochs in one ``make_train_epochs_fn`` call (the bench),
                 or E calls of ``make_train_epoch_fn`` (the JAX script's
                 ``run_variant``), each with its own host sync

    python -m physics_informed_image_segmentation_tpu_torch.scripts.ab_bench adamw pallas_adamw
    python -m physics_informed_image_segmentation_tpu_torch.scripts.ab_bench calls=epochs calls=epoch
    python -m physics_informed_image_segmentation_tpu_torch.scripts.ab_bench adamw flat=1 bs=16

The JAX script's other variants have no counterpart here, because they
choose between TPU lowerings of one function that the port computes once:
``pool`` (the port uses ``nn.MaxPool2d``), ``upsample`` (``FastUpsample``'s
lowerings of ``ConvTranspose(2, 2)``; the port has ``nn.ConvTranspose2d``),
``carry`` (``param_carry_dtype``: autocast over float32 master weights
computes the same values) and ``decoder="split"`` (a concat-free decoder,
numerically the concat decoder, which the port's U-Net is and which
``tests/test_torch_port_unet.py`` holds against JAX's split decoder).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from collections import Counter

from .. import bench
from ..utils.device import resolve_device
from ..utils.measure import build_kernels, device_facts, launch_counts

__all__ = ["parse_variant", "run_ab", "main"]

_KEYS = {"opt": "optimizer", "flat": "flat", "bs": "batch_size", "calls": "calls"}


def parse_variant(word: str) -> dict:
    """``"opt=pallas_adamw,bs=16"`` (or ``"pallas_adamw"``) → settings."""
    out = {}
    for part in word.split(","):
        key, sep, value = part.partition("=")
        if not sep:
            key, value = "opt", key
        if key not in _KEYS:
            raise ValueError(f"unknown variant setting {key!r}; one of {sorted(_KEYS)}")
        if key == "flat":
            if value not in ("0", "1"):
                raise ValueError(f"flat takes 0 or 1; got {value!r}")
            out["flat"] = value == "1"
        elif key == "bs":
            out["batch_size"] = int(value)
        else:
            out[_KEYS[key]] = value
    return out


def run_ab(variants: list, device=None, *, rounds: int = bench.ROUNDS,
           warmup: int = bench.WARMUP_CALLS, epochs: int = bench.TIMED_EPOCHS,
           n_images: int = bench.N_IMAGES, size: int = bench.IMAGE_SIZE,
           base_channels: int = bench.BASE_CHANNELS, precision: str = "bf16") -> list:
    """Time ``variants`` (words of :func:`parse_variant`) in turns; returns
    the lines: one per variant, then the ratios to the first.  A variant
    without ``bs=`` trains at the bench's batch size."""
    if not variants:
        raise ValueError("no variant to run")
    dev = resolve_device(device)
    build_kernels(dev)
    facts = device_facts(dev)
    settings = [parse_variant(v) for v in variants]
    loads = []
    for s in settings:
        kw = dict(n_images=n_images, size=size, base_channels=base_channels, epochs=epochs,
                  precision=precision, optimizer="adamw")
        kw.update(s)
        loads.append(bench.make_workload(dev, **kw))
    for wl in loads:
        for _ in range(warmup):
            bench.timed_call(wl, dev)
    seconds = [[] for _ in loads]
    launches = [Counter() for _ in loads]
    for r in range(rounds):
        order = range(len(loads)) if r % 2 == 0 else reversed(range(len(loads)))
        for i in order:
            before = launch_counts()
            s, _ = bench.timed_call(loads[i], dev)
            after = launch_counts()
            seconds[i].append(s)
            launches[i].update({k: after[k] - before[k] for k in after})
    lines = []
    rates = []
    for word, wl, secs, counts in zip(variants, loads, seconds, launches):
        r = [wl.images_per_call / s for s in secs]
        rates.append(r)
        steps = rounds * wl.steps_per_call
        lines.append({
            "metric": "train_images_per_sec_per_chip", "variant": word,
            "value": statistics.median(r), "rounds": r, "min": min(r), "max": max(r),
            "step_time_ms": statistics.median(secs) / wl.steps_per_call * 1e3,
            "batch_size": int(wl.idx.shape[2]), "calls": wl.calls,
            "launches_per_step": {k: v / steps for k, v in counts.items()},
            "device_kind": facts["device_kind"], "card": facts["card"]})
    ratios = {}
    for word, r in zip(variants[1:], rates[1:]):
        turns = [b / a for a, b in zip(rates[0], r)]
        ratios[f"{word} / {variants[0]}"] = {"median": statistics.median(turns), "turns": turns,
                                             "min": min(turns), "max": max(turns)}
    lines.append({"ab_ratios": ratios, "rounds": rounds, "device_kind": facts["device_kind"],
                  "card": facts["card"]})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=["adamw", "flat_adamw"],
                    help="variants (default: adamw flat_adamw)")
    bench.add_workload_args(ap)
    args = ap.parse_args(argv)
    for line in run_ab(args.variants, args.device, rounds=args.rounds, warmup=args.warmup,
                       epochs=args.epochs, n_images=args.images, size=args.size,
                       base_channels=args.base_channels, precision=args.precision):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
