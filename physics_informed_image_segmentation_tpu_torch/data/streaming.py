"""Streaming input pipeline for datasets that do not fit on the device.

Counterpart of ``physics_informed_image_segmentation_tpu/data/streaming.py``.
The default pipeline (:mod:`.pipeline`) keeps a whole split on the device;
this one streams host batches:

* :class:`HostDataset`: images and masks as host numpy arrays, or a
  ``decode`` callback that makes a batch from its indices;
* :func:`batch_iterator`: one epoch's batches, shuffled from
  ``SeedSequence([seed, epoch])``, the ragged last batch padded with index
  0 and ``valid`` 0 there (the JAX package's orders and masks, bit for bit);
* :func:`chunk_batches`: K consecutive batches stacked into one chunk for
  :func:`..train.engine.make_train_chunk_fn`, the last chunk padded with
  all-invalid batches;
* :func:`prefetch_to_device`: a background thread that stages upcoming
  items on the device, so the copy of item i+k overlaps the compute of
  item i.  On CUDA the arrays go through pinned host memory and
  ``non_blocking`` copies on a side stream; the consuming stream waits on
  an event recorded after the copies, and ``record_stream`` ties the
  buffers' lifetime to it.  On the CPU the items become tensors that
  share the arrays' memory.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .pipeline import num_batches

__all__ = [
    "HostDataset",
    "batch_iterator",
    "chunk_batches",
    "prefetch_to_device",
]


@dataclass
class HostDataset:
    """A split in host memory, optionally decoded lazily.

    Either dense ``images``/``masks`` arrays or a ``decode`` callback
    mapping an index array to an ``(images, masks)`` batch.
    """

    n: int
    images: Optional[np.ndarray] = None
    masks: Optional[np.ndarray] = None
    decode: Optional[Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]] = None

    def __post_init__(self):
        if self.images is None and self.decode is None:
            raise ValueError("need images/masks arrays or a decode callback")

    def take(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if self.decode is not None:
            return self.decode(indices)
        return self.images[indices], self.masks[indices]


def batch_iterator(
    data: HostDataset,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int = 0,
    epoch: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(images, masks, valid)`` host batches for one epoch.

    The final ragged batch is padded (repeating index 0) with ``valid``
    zeroed on the padding, the masking contract of the resident pipeline.
    """
    order = np.arange(data.n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(order)
    nb = num_batches(data.n, batch_size)
    pad = nb * batch_size - data.n
    valid = np.concatenate([np.ones(data.n, np.float32), np.zeros(pad, np.float32)])
    order = np.concatenate([order, np.zeros(pad, order.dtype)])
    for b in range(nb):
        sel = order[b * batch_size:(b + 1) * batch_size]
        images, masks = data.take(sel)
        yield images, masks, valid[b * batch_size:(b + 1) * batch_size]


def chunk_batches(
    iterator: Iterator[tuple[np.ndarray, ...]],
    k: int,
) -> Iterator[tuple[np.ndarray, ...]]:
    """Stack ``k`` consecutive ``(images, masks, valid)`` batches into one
    ``(k, B, ...)`` chunk for :func:`..train.engine.make_train_chunk_fn`.

    The final ragged chunk is padded by repeating its first batch with
    ``valid`` zeroed: every chunk has one shape, and the padding steps are
    skipped by the chunk function.
    """
    buf: list[tuple[np.ndarray, ...]] = []

    def emit():
        return tuple(np.stack(parts) for parts in zip(*buf))

    for item in iterator:
        buf.append(item)
        if len(buf) == k:
            yield emit()
            buf = []
    if buf:
        x0, y0, v0 = buf[0]
        buf.extend((x0, y0, np.zeros_like(v0)) for _ in range(k - len(buf)))
        yield emit()


_END = object()


def prefetch_to_device(
    iterator: Iterator,
    size: int = 2,
    device=None,
    shard: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Iterator:
    """Stage up to ``size`` upcoming items of ``iterator`` (tuples of numpy
    arrays) on ``device`` from a background thread; yields tuples of
    tensors in the iterator's order.

    ``device``: CUDA unless ``"cpu"`` is asked for (see the module
    docstring for how each is fed).  ``shard``: a cut applied to every
    array before it is copied, e.g. :func:`..parallel.mesh.batch_sharding`'s,
    so that a rank copies only its share.  An exception raised by the
    iterator is raised again here; closing the generator stops the thread.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def stage(item):
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in item]
        if shard is not None:
            host = [shard(t) for t in host]
        if copy_stream is None:
            return tuple(host), None
        with torch.cuda.stream(copy_stream):
            out = tuple(t.pin_memory().to(dev, non_blocking=True) for t in host)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def producer():
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            for item in iterator:
                if stop.is_set():
                    return
                put(stage(item))
            put(_END)
        except Exception as e:  # noqa: BLE001 — raised again at the consumer
            put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            tensors, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(ready)
                for t in tensors:
                    t.record_stream(consumer)
            yield tensors
    finally:
        stop.set()
        thread.join()
