"""Edge-partitioned R-GCN aggregation under shard_map.

Partitioning: the globally (relation, dst)-sorted, tile-aligned edge list
is cut into ``num_shards`` contiguous chunks of equal (padded) size, each
a whole number of grouped-matmul tiles. Contiguity keeps
relation groups intact inside each shard (the grouped matmul still sees
relation-sorted rows; a relation spanning a cut simply appears in both
shards' group_sizes) and keeps dst ranges roughly local per shard.

Execution: inside ``shard_map`` each device gathers from the replicated
feature table, runs its shard's grouped matmul + scaled segment-sum, and a
single ``lax.psum`` over the edge axis combines partial node aggregations
(per-node partitioning with all-to-all halo exchange is the refinement in
parallel/halo.py). Parameters and
features are replicated (they are KB-to-MB scale for this model family);
shard_map's replication rules auto-insert the psum for their cotangents,
so the whole thing is transparently differentiable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scaling_rgcn_training_tpu.ops.grouped_matmul import (
    TILE, aligned_group_layout, grouped_matmul)
from scaling_rgcn_training_tpu.parallel.mesh import EDGE_AXIS


class ShardedRelEdges(NamedTuple):
    """[S, E_shard]-shaped edge arrays + [S, num_slots] group sizes.

    ``num_nodes``/``num_shards`` are static aux. Padding rows carry
    ``norm = 0`` and live in the final (empty) relation slot of their shard.
    """

    src: jnp.ndarray
    dst: jnp.ndarray
    norm: jnp.ndarray
    group_sizes: jnp.ndarray
    num_nodes: int
    num_shards: int


jax.tree_util.register_pytree_node(
    ShardedRelEdges,
    lambda e: ((e.src, e.dst, e.norm, e.group_sizes), (e.num_nodes, e.num_shards)),
    lambda aux, ch: ShardedRelEdges(*ch, num_nodes=aux[0], num_shards=aux[1]),
)


def shard_rel_edges(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_type: np.ndarray,
    num_nodes: int,
    num_slots: int,
    num_shards: int,
    pad_to_multiple: int = 512,
    cache_dir: Optional[str] = None,
) -> ShardedRelEdges:
    """Host-side: sort globally, normalize, cut into equal padded shards.

    ``cache_dir``: persist/load the plan on disk (utils/plancache.py)."""
    from scaling_rgcn_training_tpu.utils.plancache import get_or_build

    return get_or_build(
        cache_dir, "shardededges", (edge_src, edge_dst, edge_type),
        (num_nodes, num_slots, num_shards, pad_to_multiple),
        lambda: _shard_rel_edges_host(edge_src, edge_dst, edge_type,
                                      num_nodes, num_slots, num_shards,
                                      pad_to_multiple))


def _shard_rel_edges_host(edge_src, edge_dst, edge_type, num_nodes,
                          num_slots, num_shards,
                          pad_to_multiple) -> ShardedRelEdges:
    """Host-side build with numpy leaves (see utils/plancache.to_device)."""
    edge_src = np.asarray(edge_src, np.int32)
    edge_dst = np.asarray(edge_dst, np.int32)
    edge_type = np.asarray(edge_type, np.int32)
    order = np.lexsort((edge_dst, edge_type))
    src, dst, typ = edge_src[order], edge_dst[order], edge_type[order]

    keys = typ.astype(np.int64) * num_nodes + dst.astype(np.int64)
    _, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    norm = (1.0 / counts[inv]).astype(np.float32)

    # one tile-aligned layout of num_shards equal chunks: chunk boundaries
    # fall on tile boundaries, so each shard's groups stay tile-aligned
    step = int(np.lcm(TILE, pad_to_multiple))
    pos, sizes = aligned_group_layout(typ, num_slots, num_shards * step)
    per = int(sizes.sum()) // num_shards
    rows = np.zeros(num_shards * per, np.int32)
    flat_src, flat_dst = rows.copy(), rows.copy()
    flat_norm = np.zeros(num_shards * per, np.float32)
    flat_src[pos], flat_dst[pos], flat_norm[pos] = src, dst, norm
    group = np.repeat(np.arange(num_slots), sizes).reshape(num_shards, per)
    s_gs = np.stack([np.bincount(g, minlength=num_slots) for g in group]
                    ).astype(np.int32)
    s_src = flat_src.reshape(num_shards, per)
    s_dst = flat_dst.reshape(num_shards, per)
    s_norm = flat_norm.reshape(num_shards, per)

    return ShardedRelEdges(
        src=s_src, dst=s_dst, norm=s_norm,
        group_sizes=s_gs, num_nodes=int(num_nodes),
        num_shards=int(num_shards))


def device_put_sharded_edges(edges: ShardedRelEdges, mesh: Mesh) -> ShardedRelEdges:
    """Place each shard on its device (leading axis over the edge axis)."""
    spec = NamedSharding(mesh, P(EDGE_AXIS))
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(EDGE_AXIS, *([None] * (a.ndim - 1)))))
    return ShardedRelEdges(
        src=put(edges.src), dst=put(edges.dst), norm=put(edges.norm),
        group_sizes=put(edges.group_sizes),
        num_nodes=edges.num_nodes, num_shards=edges.num_shards)


def _local_aggregate(x, src, dst, norm, group_sizes, w, num_nodes, backend):
    """One device's shard: gather -> grouped matmul -> scale -> segment-sum."""
    from scaling_rgcn_training_tpu.ops.rgcn_conv import take_rows

    msg = grouped_matmul(take_rows(x, src), w, group_sizes, backend=backend)
    msg = msg * norm[:, None]
    return jax.ops.segment_sum(msg, dst, num_segments=num_nodes)


def sharded_aggregate(
    x: jnp.ndarray,
    w: jnp.ndarray,
    edges: ShardedRelEdges,
    mesh: Mesh,
    backend: Optional[str] = None,
) -> jnp.ndarray:
    """psum over the edge axis of per-shard partial aggregations -> [N, out]."""

    def body(x_rep, src, dst, norm, gs, w_rep):
        partial = _local_aggregate(
            x_rep, src[0], dst[0], norm[0], gs[0], w_rep,
            edges.num_nodes, backend)
        return jax.lax.psum(partial, EDGE_AXIS)

    shard = P(EDGE_AXIS)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), shard, shard, shard, shard, P()),
        out_specs=P(),
        check_vma=False,
    )(x, edges.src, edges.dst, edges.norm, edges.group_sizes, w)


def sharded_rgcn_conv(x, edges: ShardedRelEdges, params, mesh: Mesh,
                      backend: Optional[str] = None,
                      compute_dtype=None) -> jnp.ndarray:
    """Drop-in R-GCN conv over partitioned edges (same math as
    ops.rgcn_conv.rgcn_conv — PyG RGCNConv semantics, SURVEY.md L0).
    ``compute_dtype``: low-precision per-edge streams, f32 reductions."""
    from scaling_rgcn_training_tpu.ops.rgcn_conv import materialize_weight

    w = materialize_weight(params)
    if compute_dtype is not None:
        cd = jnp.dtype(compute_dtype)
        agg = sharded_aggregate(x.astype(cd), w.astype(cd), edges, mesh,
                                backend=backend)
    else:
        agg = sharded_aggregate(x, w, edges, mesh, backend=backend)
    return agg + x @ params.root + params.bias
