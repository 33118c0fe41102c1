"""DeviceGraph: the frozen pytree of device arrays one graph trains on.

The replacement for the reference's PyG ``Data`` object
(graphs/graph.py:65-69 + dataset.py:30-35): relation-sorted static-shaped
edge arrays (see ops/rgcn_conv.py) plus split index/label arrays, ready to
be closed over by a jitted training step. Built once per graph on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from scaling_rgcn_training_tpu.ops.rgcn_conv import RelEdges, build_rel_edges
from scaling_rgcn_training_tpu.graphs.graph import Graph


class DeviceGraph(NamedTuple):
    """Edges + splits for one graph. Summary graphs carry only the train split."""

    edges: RelEdges
    x_train: jnp.ndarray          # int32 [T]  node ids with labels
    y_train: jnp.ndarray          # float32 [T, C]  multi-hot (org) / soft (summary)
    x_val: Optional[jnp.ndarray] = None
    y_val: Optional[jnp.ndarray] = None
    x_test: Optional[jnp.ndarray] = None
    y_test: Optional[jnp.ndarray] = None
    # locality reorder (halo partition only): node_perm[old_id] = new_id.
    # Index arrays above are already remapped; embeddings entering or
    # leaving the model must go through it (trainer._permute_embedding /
    # unpermute via gather).
    node_perm: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return self.edges.num_nodes


def build_device_graph(graph: Graph, pad_to_multiple: int = 512,
                       mesh=None, partition: Optional[str] = None,
                       reorder: bool = False,
                       plan_cache: Optional[str] = None) -> DeviceGraph:
    """Lower a host ``Graph`` (with training tensors attached) to device arrays.

    With ``mesh`` (a ``jax.sharding.Mesh``) and ``partition`` ("edge" or
    "halo"), the edge list is partitioned across the mesh instead —
    ``rgcn_conv`` dispatches on the edge pytree type, so models and the
    trainer run unchanged (the reference is single-device,
    model/modelTrainer.py:16; this is the multi-device scaling path).

    ``reorder`` (halo only): relabel nodes by label-propagation clustering
    (parallel/reorder.py) before partitioning, shrinking the halo exchange
    on community-structured graphs. The split index arrays are remapped;
    ``node_perm`` records the relabeling for embedding import/export.
    """
    if mesh is not None and partition:
        num_shards = mesh.devices.size
        src, dst = graph.edge_src, graph.edge_dst
        node_perm = None
        remap = lambda a: a
        if reorder and partition == "halo":
            from scaling_rgcn_training_tpu.parallel.reorder import locality_reorder

            node_perm = locality_reorder(src, dst, graph.num_nodes,
                                         num_shards=num_shards)
            src, dst = node_perm[src], node_perm[dst]
            remap = lambda a: None if a is None else node_perm[np.asarray(a)]
        if partition == "edge":
            from scaling_rgcn_training_tpu.parallel import (
                device_put_sharded_edges, shard_rel_edges)

            edges = device_put_sharded_edges(shard_rel_edges(
                src, dst, graph.edge_type,
                graph.num_nodes, graph.num_relation_slots, num_shards,
                pad_to_multiple=pad_to_multiple, cache_dir=plan_cache), mesh)
        elif partition == "halo":
            from scaling_rgcn_training_tpu.parallel import (
                device_put_halo_edges, halo_partition_edges)

            edges = device_put_halo_edges(halo_partition_edges(
                src, dst, graph.edge_type,
                graph.num_nodes, graph.num_relation_slots, num_shards,
                pad_to_multiple=pad_to_multiple, cache_dir=plan_cache), mesh)
        else:
            raise ValueError(f"unknown partition {partition!r}")
        as_dev = lambda a: None if a is None else jnp.asarray(a)
        return DeviceGraph(
            edges=edges,
            x_train=as_dev(remap(graph.x_train)), y_train=as_dev(graph.y_train),
            x_val=as_dev(remap(graph.x_val)), y_val=as_dev(graph.y_val),
            x_test=as_dev(remap(graph.x_test)), y_test=as_dev(graph.y_test),
            node_perm=node_perm,
        )
    edges = build_rel_edges(
        graph.edge_src, graph.edge_dst, graph.edge_type,
        num_nodes=graph.num_nodes,
        num_slots=graph.num_relation_slots,
        pad_to_multiple=pad_to_multiple,
        cache_dir=plan_cache,
    )
    as_dev = lambda a: None if a is None else jnp.asarray(a)
    return DeviceGraph(
        edges=edges,
        x_train=as_dev(graph.x_train),
        y_train=as_dev(graph.y_train),
        x_val=as_dev(graph.x_val),
        y_val=as_dev(graph.y_val),
        x_test=as_dev(graph.x_test),
        y_test=as_dev(graph.y_test),
    )


def model_num_nodes(dev_graph: DeviceGraph) -> int:
    """Node-table row count models must allocate for this graph.

    The halo partition pads nodes to ``num_shards * n_per`` so every
    device owns an equal contiguous range; embeddings/logits carry the
    phantom rows (they receive no edges and no labels)."""
    edges = dev_graph.edges
    if type(edges).__name__ == "HaloShardedEdges":
        from scaling_rgcn_training_tpu.parallel import padded_num_nodes

        return padded_num_nodes(edges)
    return edges.num_nodes
