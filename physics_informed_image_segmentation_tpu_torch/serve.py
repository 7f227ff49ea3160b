"""Inference / serving path.

Counterpart of ``physics_informed_image_segmentation_tpu/serve.py``: a
:class:`Predictor` around a fixed-batch forward pass of a trained U-Net,
with automatic padding, test-time augmentation over the 8 dihedral
symmetries, device-resident and tiled inference, plus the helpers of the
``predict`` CLI (``python -m physics_informed_image_segmentation_tpu_torch.predict``).

The public layout is the JAX package's: images in and out are
``(N, H, W[, 1])``, outputs float32 ``(N, H, W, 1)``; NCHW is internal.

Precision.  ``"bf16"`` keeps a bfloat16 copy of the weights (made once,
when ``params`` is assigned), casts the input down to bfloat16 and runs
every layer in it; the output convolution's result is cast to float32
before the sigmoid.  Those are the places where the JAX model rounds
(``x.astype(dtype)`` on entry, ``.astype(float32)`` after ``out_conv``).
It is not ``torch.autocast``, which would cast the float32 weights again
on every call.

Checkpoints are ``.pth`` state dicts with the reference keys (the files
:func:`..train.checkpoint.save_params` writes, or the reference
implementation's own), or the Flax ``.msgpack`` files that the JAX
package's ``save_params`` writes, in float32 or bf16.

The output path.  :meth:`Predictor.predict` hands each chunk's result
to the host as soon as the chunk is launched, not after the last one.
With a ``threshold`` the card compares the chunk's float32 probabilities
with it (NumPy's comparison of a float32 array with that scalar) and the
payload is a 1-byte mask; without one it is the float32 probabilities.
The payload is copied, ``non_blocking``, into one of two page-locked
host buffers (a ring kept on the Predictor, made at the first request of
each chunk shape and payload type), and the host unpacks chunk i into
the request's own float32 array while the card runs chunk i+1.  On the
CPU the same order runs on plain tensors.  The ring makes a Predictor
unsafe to call from two threads at once.

Under ``torch.profiler`` a request is span ``piis.predict``
(:func:`.utils.profiling.span`), with one ``piis.upload``, one
``piis.forward``, one ``piis.threshold`` (with a threshold) and one
``piis.fetch`` a chunk, and a last ``piis.fetch``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .data.augment import d4_apply as _d4_apply
from .data.augment import d4_invert as _d4_invert
from .models import TransUNet, build_model
from .train.checkpoint import load_params
from .utils.device import resolve_device, set_precision
from .utils.profiling import span

__all__ = ["Predictor", "load_image_for_inference"]


def load_image_for_inference(path, image_size=(128, 128)) -> np.ndarray:
    """Decode one grayscale image exactly like the training pipeline
    (bilinear resize, then per-image min-max normalisation)."""
    from PIL import Image

    th, tw = image_size
    img = Image.open(path).convert("L").resize((tw, th), resample=Image.BILINEAR)
    arr = np.array(img, dtype=np.float32)
    arr = (arr - arr.min()) / (arr.max() - arr.min() + 1e-8)
    return arr[..., None]


class Predictor:
    """Batched inference on a trained checkpoint.

    >>> p = Predictor("models/unet_pde_regularized.pth")
    >>> probs = p.predict(images)            # (N, H, W, 1) in (0, 1)
    >>> masks = p.predict(images, threshold=0.5)

    Inputs are padded to ``batch_size``, so every forward pass has one
    shape.  It runs on the GPU and raises without one, unless given
    ``device="cpu"``.  ``model`` is a module, moved to that device and to
    the compute type, or a name of :func:`..models.build_model`: ``"unet"``
    (the default, at ``base_channels``) or ``"transunet"`` (at its
    published widths, for ``image_size``).  A TransUNet takes images of its
    own side only, so ``image_size`` must be ``(img_size, img_size)``.

    Results come back through a ring of two page-locked host buffers a
    chunk (see the module's docstring); ``predict`` returns a fresh array
    every call.  The ring is the Predictor's own state: it is not
    re-entrant across threads.  ``fetch_counts`` totals, over the
    Predictor's requests, the ``chunks`` fetched, those whose payload was
    the mask made on the card (``masks_on_card``), those unpacked while a
    later chunk of their request was already launched (``overlapped``),
    and the ``host_bytes`` copied to the host.
    """

    def __init__(
        self,
        checkpoint_path,
        model=None,
        batch_size: int = 8,
        image_size=(128, 128),
        precision: str = "bf16",
        base_channels: int = 64,
        device=None,
    ):
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if set_precision(precision) == "bf16" else torch.float32
        if model is None or isinstance(model, str):
            name = model or "unet"
            model = build_model(name, **(dict(base_channels=base_channels) if name == "unet"
                                         else dict(img_size=image_size[0])))
        if isinstance(model, TransUNet) and tuple(image_size) != (model.img_size,) * 2:
            raise ValueError(f"image_size {tuple(image_size)} is not the TransUNet's "
                             f"{(model.img_size,) * 2}")
        # read in float32 and in the model's own key layout, kept on the
        # host as read; the model then takes the compute type once
        self._params = {k: v.detach().to("cpu", copy=True) for k, v in
                        load_params(checkpoint_path, model.float()).state_dict().items()}
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.batch_size = batch_size
        self.image_size = tuple(image_size)
        self._ring = {}  # (chunk shape, payload dtype) -> two (tensor, its numpy view, event)
        self.fetch_counts = {"chunks": 0, "masks_on_card": 0, "overlapped": 0, "host_bytes": 0}

    @property
    def params(self):
        """The weights as assigned: a ``state_dict`` with the reference keys."""
        return self._params

    @params.setter
    def params(self, value):
        # the cast to the compute type happens once, here, and not on
        # every call; assigning new weights takes effect on the next call
        self._params = value
        self.model.load_state_dict(value)

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) float32 on the device → (B, H, W, C_out) float32."""
        with span("piis.forward"):
            out = self.model(x.permute(0, 3, 1, 2).to(self.dtype))
            return out.permute(0, 2, 3, 1)

    def _forward_tta(self, x: torch.Tensor) -> torch.Tensor:
        # all 8 dihedral symmetries as one 8B-image batch, inverted and
        # averaged in float32 in the output's shape
        b = x.shape[0]
        pred = self._forward(torch.cat([_d4_apply(x, c) for c in range(8)]))
        acc = _d4_invert(pred[:b], 0)
        for c in range(1, 8):
            acc = acc + _d4_invert(pred[c * b:(c + 1) * b], c)
        return acc / 8.0

    def predict_device(self, images, tta: bool = False) -> torch.Tensor:
        """Device-to-device batched inference with no host round trip and
        no synchronisation, for pipelines whose images already live on
        the device.

        ``images``: (N, H, W[, 1]) tensor (or array) with N a multiple of
        ``batch_size``; returns an (N, H, W, 1) float32 probability tensor
        on the device.

        ``tta=True`` runs all 8 dihedral symmetries of a chunk as one
        ``8*batch_size``-image batch: about 8x the peak activation memory
        of the plain path.
        """
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        if x.dim() == 3:
            x = x[..., None]
        if x.dim() != 4:
            raise ValueError(f"expected (N, H, W[, 1]) images, got {tuple(x.shape)}")
        if tta and x.shape[1] != x.shape[2]:
            raise ValueError("tta requires square images")
        n = x.shape[0]
        if n % self.batch_size:
            raise ValueError(
                f"N={n} must be a multiple of batch_size={self.batch_size} "
                "(pad, or use predict() which pads automatically)"
            )
        forward = self._forward_tta if tta else self._forward
        return torch.cat([forward(x[i:i + self.batch_size])
                          for i in range(0, n, self.batch_size)])

    def _slots(self, payload: torch.Tensor) -> list:
        """The ring's two slots for ``payload``'s shape and dtype, made at
        the first request that needs them: a host tensor (page-locked on
        CUDA), its numpy view, and an event (None on the CPU)."""
        key = (tuple(payload.shape), payload.dtype)
        if key not in self._ring:
            cuda = self.device.type == "cuda"
            slots = []
            for _ in range(2):
                host = torch.empty(key[0], dtype=key[1], pin_memory=cuda)
                slots.append((host, host.numpy(), torch.cuda.Event() if cuda else None))
            self._ring[key] = slots
        return self._ring[key]

    @staticmethod
    def _unpack(out: np.ndarray, start: int, rows: int, view: np.ndarray, ready) -> None:
        """Wait for a slot's copy and write its valid rows into ``out``
        (a mask's 0/1 become float32 0/1 exactly)."""
        if ready is not None:
            ready.synchronize()
        out[start:start + rows] = view[:rows]

    def _run_chunks(self, x: np.ndarray, forward, threshold) -> np.ndarray:
        """Run the padded chunks and bring each one's payload to the host
        while the next one runs; returns a fresh (N, H, W, C) float32 array.

        Chunk i is copied into slot i % 2 and unpacked after chunk i+1 has
        been launched (the last one after the loop).  So slot i % 2 is
        written again, by chunk i+2, only after the host has waited for
        chunk i's copy and unpacked it: no copy overwrites a slot the host
        has yet to read, and the host never reads a slot a copy is still
        writing.  A request that raises midway may leave a copy in flight:
        the next copy into that slot runs after it on the same stream."""
        n = x.shape[0]
        if n == 0:
            raise ValueError("predict needs at least one image")
        if threshold is not None:
            # NumPy's ``float32 array > threshold``: float32 against a Python
            # float, float64 against a float64 scalar or array
            f32 = np.result_type(np.float32, threshold) == np.float32
            cmp_dtype = torch.float32 if f32 else torch.float64
        counts, out, pending = self.fetch_counts, None, None
        for i, start in enumerate(range(0, n, self.batch_size)):
            with span("piis.upload"):
                chunk = x[start:start + self.batch_size]
                pad = self.batch_size - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk,
                                            np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
                chunk = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            payload = forward(chunk)
            if threshold is not None:
                with span("piis.threshold"):
                    payload = payload.to(cmp_dtype) > float(threshold)
            with span("piis.fetch"):
                host, view, ready = self._slots(payload)[i % 2]
                host.copy_(payload, non_blocking=True)
                if ready is not None:
                    ready.record(torch.cuda.current_stream(self.device))
                if out is None:
                    out = np.empty((n,) + view.shape[1:], np.float32)
                if pending is not None:
                    self._unpack(out, *pending)
                    counts["overlapped"] += 1
                # only the last chunk is padded: its pad rows are never unpacked
                pending = (start, min(self.batch_size, n - start), view, ready)
            counts["chunks"] += 1
            counts["masks_on_card"] += threshold is not None
            counts["host_bytes"] += host.nbytes
        with span("piis.fetch"):
            self._unpack(out, *pending)
        return out

    def predict(
        self,
        images: np.ndarray,
        threshold: Optional[float] = None,
        tta: bool = False,
    ) -> np.ndarray:
        """(N, H, W[, 1]) images → probability maps (or binary masks when
        ``threshold`` is given), a fresh float32 array of shape (N, H, W, 1).

        ``tta=True`` averages predictions over the 8 dihedral (flip/
        rot90) symmetries, exact for segmentation (no interpolation), at
        8x the compute.  Requires square inputs.  The 8 symmetries run as
        one ``8*batch_size``-image batch, so peak activation memory is
        about 8x the plain path's.

        The masks are the host's ``(probs > threshold).astype(np.float32)``
        bit for bit; the comparison runs on the card.
        """
        with span("piis.predict"):
            x = np.asarray(images, np.float32)
            if x.ndim == 3:
                x = x[..., None]
            if tta and x.shape[1] != x.shape[2]:
                raise ValueError("tta requires square images")
            return self._run_chunks(x, self._forward_tta if tta else self._forward, threshold)

    def predict_tiled(
        self,
        image: np.ndarray,
        tile: Optional[int] = None,
        overlap: int = 32,
        threshold: Optional[float] = None,
    ) -> np.ndarray:
        """Sliding-window inference for images larger than the trained
        field size: overlapping tiles, cosine-blended seams.

        ``image``: (H, W) or (H, W, 1) float32 in [0, 1].  Returns a
        full-resolution probability map (or binary mask) of shape
        (H, W, 1).
        """
        img = np.asarray(image, np.float32)
        if img.ndim == 3:
            img = img[..., 0]
        th = tile or self.image_size[0]
        if overlap >= th:
            raise ValueError("overlap must be smaller than the tile size")
        H, W = img.shape
        stride = th - overlap

        # 1D cosine ramp window -> separable 2D blending weights
        ramp = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, overlap, dtype=np.float32))
        win1d = np.ones(th, np.float32)
        win1d[:overlap] = ramp
        win1d[-overlap:] = ramp[::-1]
        # floor the window: image borders are covered by a single tile
        # whose ramp edge must still contribute full weight after the
        # acc/wsum normalisation (w/w = 1 for any w > 0)
        win = np.maximum(np.outer(win1d, win1d), 1e-3)

        ys = list(range(0, max(H - th, 0) + 1, stride))
        xs = list(range(0, max(W - th, 0) + 1, stride))
        # the last tile sits flush with the border
        if ys[-1] != H - th and H > th:
            ys.append(H - th)
        if xs[-1] != W - th and W > th:
            xs.append(W - th)

        tiles, coords = [], []
        for y0 in ys:
            for x0 in xs:
                patch = np.zeros((th, th), np.float32)
                patch_src = img[y0:y0 + th, x0:x0 + th]
                patch[:patch_src.shape[0], :patch_src.shape[1]] = patch_src
                tiles.append(patch[..., None])
                coords.append((y0, x0, patch_src.shape[0], patch_src.shape[1]))

        preds = self.predict(np.stack(tiles))
        acc = np.zeros((H, W), np.float32)
        wsum = np.zeros((H, W), np.float32)
        for pred, (y0, x0, hh, ww) in zip(preds, coords):
            acc[y0:y0 + hh, x0:x0 + ww] += pred[:hh, :ww, 0] * win[:hh, :ww]
            wsum[y0:y0 + hh, x0:x0 + ww] += win[:hh, :ww]
        probs = (acc / np.maximum(wsum, 1e-8))[..., None]
        if threshold is None:
            return probs
        return (probs > threshold).astype(np.float32)

    def predict_files(self, paths, threshold: Optional[float] = None) -> np.ndarray:
        images = np.stack([load_image_for_inference(p, self.image_size) for p in paths])
        return self.predict(images, threshold=threshold)
