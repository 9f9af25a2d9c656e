"""Multi-process parallelism on torch.distributed: the sharded
posterior, mesh helpers, multi-host start-up (counterpart of
bayeslim_tpu/parallel/)."""
from .sharding import (
    make_mesh, shard_rime, shard_visdata, shard_pixels, ShardedLogProb,
    DistributedLogProb, replicate,
)
from . import collectives, multihost
