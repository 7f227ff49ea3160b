"""Profiling: device traces, step timing, throughput.

Counterpart of ``physics_informed_image_segmentation_tpu/utils/profiling.py``:

* :func:`sync`: wait for the device work behind a value;
* :func:`trace`: a ``torch.profiler`` trace of CPU and CUDA activity,
  written as a Chrome trace (``chrome://tracing``, Perfetto);
* :class:`StepTimer`: host-clock step times with warm-up discard;
* :class:`ThroughputMeter`: images per second, and per device.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

__all__ = ["trace", "sync", "StepTimer", "ThroughputMeter"]


def _has_cuda_tensor(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, dict):
        return any(_has_cuda_tensor(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_has_cuda_tensor(v) for v in value)
    return False


def sync(value=None) -> None:
    """Wait for pending device work: ``torch.cuda.synchronize()`` when
    ``value`` holds a CUDA tensor (or, with no value, when CUDA is in use);
    CPU work is already done when its call returns."""
    if _has_cuda_tensor(value) or (value is None and torch.cuda.is_initialized()):
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir):
    """Trace the block's CPU activity, and its CUDA activity where CUDA is
    available, with ``torch.profiler`` and write ``<log_dir>/trace.json``
    (Chrome trace format); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / "trace.json"))


@dataclass
class StepTimer:
    """Host-clock step timing with warm-up discard.

    >>> t = StepTimer(warmup=2)
    >>> for _ in range(10):
    ...     with t.step():
    ...         out = step_fn(...)
    ...         t.sync(out)
    >>> t.mean_ms
    """

    warmup: int = 1
    times: List[float] = field(default_factory=list)
    _seen: int = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    def sync(self, value) -> None:
        sync(value)

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.times) * 1e3) if self.times else float("nan")

    @property
    def p50_ms(self) -> float:
        return float(np.percentile(self.times, 50) * 1e3) if self.times else float("nan")

    @property
    def p99_ms(self) -> float:
        return float(np.percentile(self.times, 99) * 1e3) if self.times else float("nan")


@dataclass
class ThroughputMeter:
    """Images per second, and per device; ``n_devices`` 0 means the
    ``torch.distributed`` world size (1 outside a process group)."""

    n_devices: int = 0
    _images: int = 0
    _start: Optional[float] = None

    def __post_init__(self):
        if self.n_devices == 0:
            dist = torch.distributed
            self.n_devices = (dist.get_world_size()
                              if dist.is_available() and dist.is_initialized() else 1)

    def start(self) -> None:
        self._start = time.perf_counter()
        self._images = 0

    def add(self, n_images: int) -> None:
        if self._start is None:
            self.start()
        self._images += n_images

    @property
    def images_per_sec(self) -> float:
        if self._start is None or self._images == 0:
            return 0.0
        return self._images / (time.perf_counter() - self._start)

    @property
    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec / max(1, self.n_devices)

    def report(self) -> dict:
        return {
            "images": self._images,
            "images_per_sec": round(self.images_per_sec, 1),
            "images_per_sec_per_chip": round(self.images_per_sec_per_chip, 1),
            "n_devices": self.n_devices,
        }
