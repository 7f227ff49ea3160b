"""Parallelism: process-group mesh, data- and space-sharded training, halo exchange."""

from .halo import (  # noqa: F401
    halo_exchange_pad,
    halo_phase_field_loss,
    halo_physics_loss_pallas,
    halo_residual_loss,
)
from .mesh import (  # noqa: F401
    DATA_AXIS,
    SPACE_AXIS,
    Mesh,
    batch_sharding,
    batch_space_sharding,
    initialize_distributed,
    make_mesh,
)
from .sharding import (  # noqa: F401
    make_sharded_epoch_fns,
    make_sharded_train_step,
    shard_train_state,
)

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "batch_sharding",
    "batch_space_sharding",
    "DATA_AXIS",
    "SPACE_AXIS",
    "Mesh",
    "make_sharded_epoch_fns",
    "make_sharded_train_step",
    "shard_train_state",
    "halo_exchange_pad",
    "halo_residual_loss",
    "halo_physics_loss_pallas",
    "halo_phase_field_loss",
]
