"""Checkpoints: final ``.pth`` artifacts and full train states with resume.

Counterpart of ``physics_informed_image_segmentation_tpu/train/checkpoint.py``.

* :func:`save_params` / :func:`load_params`: the U-Net ``state_dict`` as a
  ``.pth`` file.  The keys are the reference keys, so a saved file loads
  into the port's :class:`..models.UNet` and into the reference PyTorch
  model alike.  :func:`load_params` also reads the Flax ``.msgpack`` that
  the JAX package's ``save_params`` writes (:mod:`..utils.flax_msgpack`,
  mapped by :func:`..utils.weights.state_dict_from_jax`).
* :func:`save_train_state` / :func:`restore_train_state`: the whole train
  state (step, parameters, optimizer state, dropout generator state) as
  ``<dir>/step_N`` files written with ``torch.save``.  A file is written
  under a temporary name and renamed into place, so a half-written
  checkpoint is never picked up.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

from ..utils.flax_msgpack import load_msgpack
from ..utils.weights import model_dropout, state_dict_from_jax

__all__ = [
    "save_params",
    "load_params",
    "save_train_state",
    "restore_train_state",
    "latest_checkpoint_step",
]


def save_params(model: torch.nn.Module, path) -> Path:
    """Save ``model.state_dict()`` (moved to the CPU) to ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def load_params(path, model: Optional[torch.nn.Module] = None):
    """Load a ``.pth`` state dict, or the parameters of a Flax ``.msgpack``
    as one (float32, bf16 leaves at their exact values); with ``model``,
    load it into the model (strictly) and return the model.

    A ``.msgpack`` takes the key layout of ``model``'s dropout, and without
    a model that of the JAX U-Net's default dropout (0.2), as in
    :func:`..utils.weights.state_dict_from_jax`."""
    if Path(path).suffix == ".msgpack":
        tree = load_msgpack(path)
        if model is None:
            state_dict = state_dict_from_jax(tree)
        else:
            state_dict = state_dict_from_jax(tree, dropout=model_dropout(model))
    else:
        state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        return state_dict
    model.load_state_dict(state_dict)
    return model


def save_train_state(
    state, ckpt_dir, step: Optional[int] = None, keep: Optional[int] = None
) -> Path:
    """Full-state checkpoint (resume-capable) at ``ckpt_dir/step_N``.

    ``keep``: after saving, delete all but the newest ``keep`` ``step_*``
    checkpoints in ``ckpt_dir`` (a full state is ~3x the parameters,
    ~250 MB at base_channels 64).  ``None`` keeps everything.
    """
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step = state.step if step is None else step
    path = ckpt_dir / f"step_{step}"
    tmp = ckpt_dir / f"step_{step}.tmp-{os.getpid()}"
    torch.save({
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "dropout_generator": state.dropout_generator.get_state(),
    }, tmp)
    os.replace(tmp, path)
    if keep is not None and keep > 0:
        for old in _checkpoint_steps(ckpt_dir)[:-keep]:
            (ckpt_dir / f"step_{old}").unlink(missing_ok=True)
    return path


def _checkpoint_steps(ckpt_dir: Path) -> list[int]:
    """Sorted complete ``step_N`` checkpoints; ignores names with other
    suffixes, such as the temporary file of an interrupted save."""
    return sorted(
        int(p.name[5:])
        for p in ckpt_dir.iterdir()
        if p.is_file() and p.name.startswith("step_") and p.name[5:].isdigit()
    )


def latest_checkpoint_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_train_state(state, ckpt_dir, step: Optional[int] = None):
    """Restore a train state saved by :func:`save_train_state` into
    ``state`` (a fresh one of the same model and optimizer) and return it.

    Tensors load onto the model's device and are copied into the state's
    own parameters and moments, which keep their storage.
    """
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    device = next(state.model.parameters()).device
    saved = torch.load(ckpt_dir / f"step_{step}", map_location=device, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    if state.step != saved["step"]:
        raise ValueError(f"checkpoint step {saved['step']} and optimizer count "
                         f"{state.step} disagree")
    state.dropout_generator.set_state(saved["dropout_generator"].cpu())
    return state
