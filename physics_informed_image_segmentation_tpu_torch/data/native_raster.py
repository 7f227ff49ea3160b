"""ctypes bindings for the native C++ polygon rasteriser.

Counterpart of ``physics_informed_image_segmentation_tpu/data/native_raster.py``
over the same source, ``native/rasterize.cpp`` (an even-odd scanline fill
and a one-pixel outline, PIL's semantics up to sub-pixel boundary cases),
with the same C functions and ``argtypes``.

The library is built on first use with ``g++ -O3 -shared -fPIC -std=c++17
-pthread`` into the package's git-ignored ``build/``, named by the hash of
the source, written to a temporary file and renamed into place
(:func:`..utils.cuda_build.start_compile`), so processes that build it at
once never load a half-written file.  A failed build raises with
``g++``'s output; nothing falls back to PIL.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np

from ..utils.cuda_build import PKG_DIR, finish_compile, hashed_library, start_compile

__all__ = ["native_available", "rasterize_native", "rasterize_batch_native"]

SOURCE = PKG_DIR.parent / "native" / "rasterize.cpp"
GXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """Build the library if needed and load it (once per process)."""
    if not SOURCE.exists():
        raise RuntimeError(f"native rasterizer unavailable: {SOURCE} not found")
    target = hashed_library(SOURCE, "rasterize")
    job = start_compile(GXX, SOURCE, target)
    if job is not None:
        try:
            finish_compile(target, *job)
        except RuntimeError as e:
            raise RuntimeError(f"native rasterizer unavailable: {e}") from None
    lib = ctypes.CDLL(str(target))
    lib.rasterize_mask.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.rasterize_mask.restype = None
    lib.rasterize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.rasterize_batch.restype = None
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here (it needs ``g++``)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _flatten_annotations(annotations: Sequence[dict]):
    """COCO annotations → (coords, counts) of the polygons with at least 6
    coordinates (the PIL path skips the others too)."""
    coords, counts = [], []
    for ann in annotations:
        seg = ann.get("segmentation", [])
        if isinstance(seg, list):
            for poly in seg:
                if len(poly) >= 6:
                    coords.append(np.asarray(poly, np.float64).reshape(-1))
                    counts.append(len(poly) // 2)
    if not coords:
        return np.zeros(0, np.float64), np.zeros(0, np.int32)
    return np.concatenate(coords), np.asarray(counts, np.int32)


def rasterize_native(annotations: Sequence[dict], original_size: tuple[int, int]) -> np.ndarray:
    """One image's polygons → float32 {0, 1} mask at the original size (H, W).

    Resizing happens in :func:`.coco.rasterize_polygons`."""
    lib = _load()
    H, W = original_size
    coords, counts = _flatten_annotations(annotations)
    mask = np.zeros((H, W), np.uint8)
    lib.rasterize_mask(_ptr(coords, ctypes.c_double), _ptr(counts, ctypes.c_int32),
                       len(counts), _ptr(mask, ctypes.c_uint8), H, W)
    return mask.astype(np.float32)


def rasterize_batch_native(per_image_annotations: Sequence[Sequence[dict]],
                           size: tuple[int, int], n_threads: int = 0) -> np.ndarray:
    """Many images' polygons, all at one size, on ``n_threads`` threads (0:
    the hardware's count) → (N, H, W) float32 masks."""
    lib = _load()
    H, W = size
    n = len(per_image_annotations)
    flat = [_flatten_annotations(anns) for anns in per_image_annotations]
    coords = np.concatenate([c for c, _ in flat]) if flat else np.zeros(0, np.float64)
    counts = np.concatenate([k for _, k in flat]) if flat else np.zeros(0, np.int32)
    poly_offsets = np.concatenate([[0], np.cumsum([len(k) for _, k in flat])]).astype(np.int32)
    coord_offsets = np.concatenate([[0], np.cumsum([len(c) for c, _ in flat])]).astype(np.int64)
    masks = np.zeros((n, H, W), np.uint8)
    lib.rasterize_batch(_ptr(coords, ctypes.c_double), _ptr(counts, ctypes.c_int32),
                        _ptr(poly_offsets, ctypes.c_int32), _ptr(coord_offsets, ctypes.c_int64),
                        n, _ptr(masks, ctypes.c_uint8), H, W, n_threads)
    return masks.astype(np.float32)
