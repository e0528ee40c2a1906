"""Scale-out over ``torch.distributed``: process meshes and data /
tensor-parallel layouts (counterpart of the JAX package's ``parallel/``)."""

from .mesh import (
    Mesh,
    barrier,
    initialize_multihost,
    local_mesh,
    make_mesh,
    process_count,
    process_index,
    shutdown,
)
from .sharding import (
    DataShard,
    ShardedParameters,
    batch_sharding,
    shard_batch,
    tensor_parallel_specs,
)

__all__ = [
    "DataShard",
    "Mesh",
    "ShardedParameters",
    "barrier",
    "batch_sharding",
    "initialize_multihost",
    "local_mesh",
    "make_mesh",
    "process_count",
    "process_index",
    "shard_batch",
    "shutdown",
    "tensor_parallel_specs",
]
