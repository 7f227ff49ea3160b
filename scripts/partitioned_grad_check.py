"""Check the JAX package's partitioned U-Net gradients against unsharded ones.

Under a ``P('data', 'space')`` batch sharding XLA's SPMD partitioner
inserts the convolutions' halos itself (``parallel/sharding.py``).  This
script differentiates the Dice+BCE loss of the U-Net (base 4, float32,
dropout 0, ``make_blobs`` images) with that sharding on several meshes of
8 virtual CPU devices and prints, per mesh and image size, the forward's
largest difference and the worst relative error of any parameter's
gradient against the unsharded program.

    python scripts/partitioned_grad_check.py [sizes ...]   (default: 32 64)
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from physics_informed_image_segmentation_tpu.data import make_blobs  # noqa: E402
from physics_informed_image_segmentation_tpu.models import UNet  # noqa: E402
from physics_informed_image_segmentation_tpu.ops import losses as L  # noqa: E402
from physics_informed_image_segmentation_tpu.parallel import make_mesh  # noqa: E402

MESHES = ((8, 1), (1, 2), (2, 2), (1, 4), (4, 2))


def check(size: int) -> None:
    model = UNet(base_channels=4, dropout=0.0, dtype=jnp.float32)
    params = model.init(jax.random.key(1), jnp.zeros((1, size, size, 1), jnp.float32))
    images, masks = make_blobs(8, size, size, seed=0)
    x, y = jnp.asarray(images), jnp.asarray(masks)

    def loss(p, x, y):
        return L.dice_bce_loss(model.apply(p, x), y, 0.5, 0.5, 1e-6)

    ref_out = jax.jit(model.apply)(params, x)
    ref_grad = jax.jit(jax.grad(loss))(params, x, y)
    for data, space in MESHES:
        mesh = make_mesh(data=data, space=space)
        sh, rep = NamedSharding(mesh, P("data", "space")), NamedSharding(mesh, P())
        out = jax.jit(model.apply, in_shardings=(rep, sh))(params, x)
        grad = jax.jit(jax.grad(loss), in_shardings=(rep, sh, sh))(params, x, y)
        worst, where = 0.0, ""
        for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(grad),
                                jax.tree_util.tree_leaves(ref_grad)):
            g, r = np.asarray(g), np.asarray(r)
            err = float(np.abs(g - r).max() / (np.abs(r).max() + 1e-30))
            if err > worst:
                worst, where = err, jax.tree_util.keystr(path)
        print(f"{size}x{size}, mesh data={data} space={space}: forward max|d| "
              f"{float(jnp.abs(out - ref_out).max()):.3e}; worst relative gradient error "
              f"{worst:.3e} at {where}", flush=True)


if __name__ == "__main__":
    for s in [int(a) for a in sys.argv[1:]] or [32, 64]:
        check(s)
