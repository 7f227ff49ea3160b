"""Profiling: device traces and the program's spans.

Counterpart of ``physics_informed_image_segmentation_tpu/utils/profiling.py``:

* :func:`sync`: wait for the device work behind a value;
* :func:`trace`: a ``torch.profiler`` trace of CPU and CUDA activity,
  written as a Chrome trace (``chrome://tracing``, Perfetto);
* :func:`span`: a named range of the program (``piis.*``, :data:`SPANS`)
  in that trace, on the host timeline beside the kernels it launched.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

__all__ = ["trace", "sync", "span", "SPANS"]

# Every span the program opens, outermost first where they nest.  Training:
# piis.epoch > piis.plan, piis.step > piis.forward, piis.objective,
# piis.backward, piis.optimizer, piis.metrics; piis.epoch > piis.val >
# piis.forward, piis.objective, piis.metrics, piis.sync; piis.epoch >
# piis.sync, piis.log.  Serving: piis.predict > piis.upload, piis.forward,
# piis.threshold (with a threshold) and piis.fetch once a chunk, and one
# more piis.fetch for the last chunk's unpack.
SPANS = ("piis.epoch", "piis.plan", "piis.step", "piis.forward", "piis.objective",
         "piis.backward", "piis.optimizer", "piis.metrics", "piis.sync", "piis.val",
         "piis.log", "piis.predict", "piis.upload", "piis.fetch", "piis.threshold")

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks the block as span ``name`` in a
    ``torch.profiler`` trace, nested under the spans open around it.

    With no profiler recording it is a shared no-op: its cost is one check
    of the profiler's flag (a ``record_function`` costs ~10 µs a block even
    then).  The range is recorded as an operation of the host timeline
    (``_RecordFunctionFast``), not as a ``record_function`` user
    annotation: kineto copies each user annotation onto the device's
    timeline as a range over the kernels it launched, which a reader of
    the device's activity would take for device time.  Autograd's backward
    runs on a thread of its own, outside every span: its operations are
    tied to their forward by the profiler's ``sequence_nr``."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _RecordFunctionFast(name)


def _cuda_device(value) -> Optional[torch.device]:
    """The CUDA device of ``value`` (a device, or the first CUDA tensor it
    holds), else None."""
    if isinstance(value, torch.device):
        return value if value.type == "cuda" else None
    if isinstance(value, torch.Tensor):
        return value.device if value.is_cuda else None
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


def sync(value=None) -> None:
    """Wait for pending device work: ``torch.cuda.synchronize`` of the
    device of ``value`` (a ``torch.device``, or the first CUDA tensor it
    holds), or of the current device when there is no value and CUDA is
    in use; CPU work is already done when its call returns."""
    dev = _cuda_device(value)
    if dev is not None or (value is None and torch.cuda.is_initialized()):
        torch.cuda.synchronize(dev)


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
