"""Process meshes, sharding rules and the multi-process setup."""

from pkr_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    gather_rows,
    make_mesh,
    param_sharding_rules,
    replicated,
    shard_params,
    weight_is_sharded,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "gather_rows",
    "make_mesh",
    "param_sharding_rules",
    "replicated",
    "shard_params",
    "weight_is_sharded",
]
