"""The U-Net forward on a batch sharded over samples and image height.

The JAX package gets the convolutions' halos from XLA's partitioner
(``parallel/sharding.py`` shards the batch as ``P('data', 'space')``);
here they are explicit.  :func:`sharded_forward_nhwc` runs the same
:class:`..models.UNet` module — its parameters, its ``state_dict`` — on
this rank's (B_loc, H_loc, W, C) block:

* with ``spatial``, before each of the 18 3×3 convolutions one row is
  exchanged with the neighbouring bands (zero rows at the global top and
  bottom, :func:`.halo.halo_exchange_pad` with ``edge="zero"``) and the
  conv runs with ``padding=(0, 1)``.  Max-pooling, the 2×2 stride-2
  transposed convolutions and the 1×1 output conv are local as long as
  H_loc is divisible by 16 (four 2× poolings), which is checked;
* spatial dropout draws the mask of the whole (B_global, C) batch from
  the shared generator and takes this rank's rows, so the bands of one
  sample agree, data ranks get independent masks, and a sharded run
  equals the single-process one at any dropout rate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import require_unet
from ..models.unet import spatial_dropout
from ..utils.device import autocast
from .halo import halo_exchange_pad
from .mesh import Mesh

__all__ = ["sharded_forward_nhwc"]

_POOLS = 4


def _unet(model, x, generator, rows, conv):
    """The U-Net's forward with ``conv(module, h)`` for each of its 18 3×3
    convolutions; ``rows`` is spatial dropout's ``batch_rows``."""

    def block(blk, h):
        act = blk.conv[1]
        h = act(conv(blk.conv[0], h))
        if blk.dropout > 0 and blk.training:
            h = spatial_dropout(h, blk.dropout, generator, rows)
        return act(conv(blk.conv[-2], h))

    e1 = block(model.enc1, x)
    e2 = block(model.enc2, model.pool(e1))
    e3 = block(model.enc3, model.pool(e2))
    e4 = block(model.enc4, model.pool(e3))
    b = block(model.bottleneck, model.pool(e4))
    d4 = block(model.dec4, torch.cat([model.up4(b), e4], dim=1))
    d3 = block(model.dec3, torch.cat([model.up3(d4), e3], dim=1))
    d2 = block(model.dec2, torch.cat([model.up2(d3), e2], dim=1))
    d1 = block(model.dec1, torch.cat([model.up1(d2), e1], dim=1))
    out = model.out_conv(d1)
    out = out.to(torch.promote_types(out.dtype, torch.float32))
    if model.output_activation == "sigmoid":
        return torch.sigmoid(out)
    return (torch.tanh(out) + 1.0) / 2.0


def check_band_rows(rows: int) -> None:
    """A band's height must survive the U-Net's four 2× poolings."""
    if rows % (2**_POOLS) != 0:
        raise ValueError(f"a band of {rows} rows is not divisible by {2**_POOLS}: "
                         "the U-Net's poolings would cross bands")


def sharded_forward_nhwc(model, x: torch.Tensor, precision: str, generator, mesh: Mesh,
                         *, spatial: bool) -> torch.Tensor:
    """This rank's (B_loc, H_loc, W, C) block → its (B_loc, H_loc, W, C_out)
    float32 probabilities (see the module docstring); the counterpart of
    :func:`..train.engine.forward_nhwc`."""
    require_unet(model, "the sharded epochs")
    if spatial:
        check_band_rows(x.shape[1])
    rows = (x.shape[0] * mesh.data, x.shape[0] * mesh.data_rank)

    def conv(m, h):
        if not spatial:
            return m(h)
        return F.conv2d(halo_exchange_pad(h, mesh, "zero"), m.weight, m.bias, padding=(0, 1))

    with autocast(x.device, precision):
        out = _unet(model, x.permute(0, 3, 1, 2), generator, rows, conv)
    return out.permute(0, 2, 3, 1)
