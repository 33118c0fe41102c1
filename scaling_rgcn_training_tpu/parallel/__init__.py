"""Distribution: device meshes + edge-partitioned SPMD execution.

The reference is single-device (model/modelTrainer.py:16, one ``.to``);
its scaling story is algorithmic (summary graphs). This package adds the
multi-device story: partition the relation-sorted edge list across a
``jax.sharding.Mesh``, aggregate locally per device, and combine partial
node aggregations with an all-reduce — the graph analogue of
data parallelism, with tensor dims small enough that replicating
parameters is free.
"""

from scaling_rgcn_training_tpu.parallel.mesh import make_mesh, use_mesh, current_mesh
from scaling_rgcn_training_tpu.parallel.spmd import (
    ShardedRelEdges,
    shard_rel_edges,
    sharded_rgcn_conv,
    device_put_sharded_edges,
)
from scaling_rgcn_training_tpu.parallel.reorder import (
    locality_reorder,
    edge_cut_fraction,
)
from scaling_rgcn_training_tpu.parallel.halo import (
    HaloShardedEdges,
    halo_partition_edges,
    halo_rgcn_conv,
    halo_aggregate,
    device_put_halo_edges,
    pad_node_array,
    padded_num_nodes,
    node_sharding,
)

__all__ = [
    "make_mesh", "use_mesh", "current_mesh",
    "ShardedRelEdges", "shard_rel_edges", "sharded_rgcn_conv",
    "device_put_sharded_edges",
    "HaloShardedEdges", "halo_partition_edges", "halo_rgcn_conv",
    "halo_aggregate", "device_put_halo_edges", "pad_node_array",
    "padded_num_nodes", "node_sharding",
    "locality_reorder", "edge_cut_fraction",
]
