"""Multi-rank runs of the PyTorch port on ``torch.distributed``: the
process group (:mod:`.distributed`) and the 1-D mesh over the env batch
(:mod:`.mesh`).  The counterpart of :mod:`reinmav_tpu.parallel`."""

from . import distributed
from .mesh import (BATCH_AXIS, COLLECTIVES, Mesh, batch_sharding, fold_in, make_mesh, replicated,
                   shard_batch, shard_state, sharded_control_rollout, sharded_dense_rollout)

__all__ = [
    "BATCH_AXIS", "COLLECTIVES", "Mesh", "batch_sharding", "distributed", "fold_in", "make_mesh",
    "replicated", "shard_batch", "shard_state", "sharded_control_rollout",
    "sharded_dense_rollout",
]
