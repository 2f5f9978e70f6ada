"""Site sharding over a mesh of devices (libpll2_tpu.parallel on
torch.distributed): `make_mesh`, `shard_partition`, `ShardedRepeatsEngine`
and `multihost`."""
from .sharding import (SITES_AXIS, ShardedRepeatsEngine, clv_sharding,
                       is_multiprocess, make_mesh, owned_shards, put_global,
                       replicated, scaler_sharding, shard_partition,
                       site_vector_sharding)
from . import multihost

__all__ = ["SITES_AXIS", "make_mesh", "shard_partition", "clv_sharding",
           "scaler_sharding", "site_vector_sharding", "replicated",
           "ShardedRepeatsEngine", "put_global", "is_multiprocess",
           "owned_shards", "multihost"]
