"""Node-partitioned R-GCN aggregation with overlapped halo exchange.

The edge-partition path (parallel/spmd.py) replicates features and
all-reduces full [N, h] partials — O(N) interconnect traffic per layer regardless
of how sparse the cut is. This module is the scalable refinement promised
there (SURVEY.md §7 step 6): partition NODES into contiguous ranges, give
each device the edges whose destination it owns, and exchange only the
boundary ("halo") source features a device actually reads, via one
``lax.all_to_all`` over the mesh axis (NCCL over NVLink on GPUs). Per-device traffic is then
O(E/S + halo) instead of O(N), and both activations and outputs stay
node-sharded end to end — no replicated [N, h] tensor ever materializes.

Compute/communication overlap: each shard's edge list is split into an
OWNER-LOCAL segment (src owned by the same shard — the vast majority on a
well-partitioned graph) and a HALO segment (src remote). The local
aggregation consumes only ``x_own`` and therefore has no data dependence
on the all_to_all; XLA's async-collective scheduler issues the exchange
as a collective-start, runs the local grouped-matmul + segment-sum while
rows are in flight, and joins at the collective-done only for the (small)
halo segment. No manual double-buffering needed — the dataflow is what
unlocks the overlap.

Layout (host-side, static per graph — built once by
:func:`halo_partition_edges`):

- nodes padded to ``S * n_per``; device ``s`` owns rows
  ``[s*n_per, (s+1)*n_per)``;
- each edge lives on the owner of its ``dst``; the two per-shard edge
  segments are each (relation, dst)-sorted, tile-aligned and padded to
  common static lengths, so the grouped matmuls see relation-contiguous
  rows exactly like the single-device layout (ops/rgcn_conv.py);
- for every (reader s, owner p) pair the sorted unique remote sources
  are precomputed: ``send_idx[p, s]`` are owner-local rows p must ship
  to s; halo-segment edges address the received ``[S*H, d]`` buffer
  through ``hsrc`` — at runtime the exchange is one gather + one
  all_to_all, with zero index arithmetic on device.

The per-(relation, dst) mean normalization is computed globally before
partitioning (dst-ownership keeps every (rel, dst) group on one shard, so
the coefficients are exact). shard_map makes the whole thing transparently
differentiable: the all_to_all transposes to an all_to_all of cotangents,
and every scatter in the backward targets local-sized tables.

Reference parity: the math is still PyG ``RGCNConv`` semantics
(model/layers.py:15-23) — only the dataflow is distributed.
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


class HaloShardedEdges(NamedTuple):
    """Static per-graph plan for node-partitioned execution.

    Leading axis of every array is the shard axis ``S``. The owner-local
    segment (``lsrc``/``ldst``/``lnorm``/``lgs``) indexes ``x_own``
    directly; the halo segment (``hsrc``/``hdst``/``hnorm``/``hgs``)
    indexes the received ``[S*H, d]`` halo buffer. ``*dst`` are owner-local
    destination rows. Padding edge rows carry ``norm = 0`` and live in the
    final relation slot of their segment.
    """

    lsrc: jnp.ndarray          # int32 [S, E_loc]   into x_own
    ldst: jnp.ndarray          # int32 [S, E_loc]
    lnorm: jnp.ndarray         # float32 [S, E_loc]
    lgs: jnp.ndarray           # int32 [S, num_slots]
    hsrc: jnp.ndarray          # int32 [S, E_halo]  into the halo buffer
    hdst: jnp.ndarray          # int32 [S, E_halo]
    hnorm: jnp.ndarray         # float32 [S, E_halo]
    hgs: jnp.ndarray           # int32 [S, num_slots]
    send_idx: jnp.ndarray      # int32 [S, S, H] owner-local rows to ship
    num_nodes: int             # true N (pre-padding)
    n_per: int                 # owned rows per device
    halo: int                  # H: max remote rows any (reader, owner) pair ships
    num_shards: int


jax.tree_util.register_pytree_node(
    HaloShardedEdges,
    lambda e: ((e.lsrc, e.ldst, e.lnorm, e.lgs,
                e.hsrc, e.hdst, e.hnorm, e.hgs, e.send_idx),
               (e.num_nodes, e.n_per, e.halo, e.num_shards)),
    lambda aux, ch: HaloShardedEdges(*ch, num_nodes=aux[0], n_per=aux[1],
                                     halo=aux[2], num_shards=aux[3]),
)


def _sorted_padded_segment(src, dst, typ, norm, num_slots, pad_len):
    """(relation, dst)-sort one edge segment into the tile-aligned layout
    (ops/grouped_matmul.py) of ``pad_len`` rows."""
    order = np.lexsort((dst, typ))
    pos, gs = aligned_group_layout(typ[order], num_slots, pad_len)
    assert gs.sum() == pad_len, (int(gs.sum()), pad_len)
    o_src = np.zeros(pad_len, np.int32)
    o_dst = np.zeros(pad_len, np.int32)
    o_norm = np.zeros(pad_len, np.float32)
    o_src[pos], o_dst[pos], o_norm[pos] = src[order], dst[order], norm[order]
    return o_src, o_dst, o_norm, gs


def _aligned_rows(typ, num_slots):
    return int(aligned_group_layout(typ, num_slots)[1].sum())


def halo_partition_edges(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_type: np.ndarray,
    num_nodes: int,
    num_slots: int,
    num_shards: int,
    pad_to_multiple: int = 512,
    halo_multiple: int = 8,
    cache_dir: Optional[str] = None,
) -> HaloShardedEdges:
    """Host-side, once per graph: dst-owner partition + halo exchange plan.

    ``cache_dir``: persist/load the plan on disk (utils/plancache.py)."""
    from scaling_rgcn_training_tpu.utils.plancache import get_or_build

    return get_or_build(
        cache_dir, "haloedges", (edge_src, edge_dst, edge_type),
        (num_nodes, num_slots, num_shards, pad_to_multiple, halo_multiple),
        lambda: _halo_partition_edges_host(
            edge_src, edge_dst, edge_type, num_nodes, num_slots,
            num_shards, pad_to_multiple, halo_multiple))


def _halo_partition_edges_host(
    edge_src, edge_dst, edge_type, num_nodes, num_slots, num_shards,
    pad_to_multiple, halo_multiple,
) -> HaloShardedEdges:
    """Host-side build with numpy leaves (see utils/plancache.to_device)."""
    edge_src = np.asarray(edge_src, np.int32)
    edge_dst = np.asarray(edge_dst, np.int32)
    edge_type = np.asarray(edge_type, np.int32)
    s_n = num_shards
    n_per = -(-num_nodes // s_n)

    # global per-(rel, dst) mean coefficients (exact: dst-ownership keeps
    # each group on one shard)
    keys = edge_type.astype(np.int64) * num_nodes + edge_dst.astype(np.int64)
    _, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    norm_all = (1.0 / counts[inv]).astype(np.float32)

    owner = edge_dst // n_per
    need = [[None] * s_n for _ in range(s_n)]
    shards = []
    for s in range(s_n):
        m = owner == s
        src_s, dst_s, typ_s, norm_s = (edge_src[m], edge_dst[m],
                                       edge_type[m], norm_all[m])
        src_owner = src_s // n_per
        own = src_owner == s
        shards.append((src_s, dst_s, typ_s, norm_s, src_owner, own))
        for p in range(s_n):
            need[s][p] = np.unique(src_s[src_owner == p]) if p != s else \
                np.empty(0, np.int64)

    h = max((len(need[s][p]) for s in range(s_n) for p in range(s_n)),
            default=0)
    h = max(halo_multiple, -(-h // halo_multiple) * halo_multiple)

    step = int(np.lcm(TILE, pad_to_multiple))
    pad = lambda ne: max(step, -(-ne // step) * step)
    e_loc = pad(max(_aligned_rows(sh[2][sh[5]], num_slots) for sh in shards))
    e_halo = pad(max(_aligned_rows(sh[2][~sh[5]], num_slots) for sh in shards))

    lsrc = np.zeros((s_n, e_loc), np.int32)
    ldst = np.zeros((s_n, e_loc), np.int32)
    lnorm = np.zeros((s_n, e_loc), np.float32)
    lgs = np.zeros((s_n, num_slots), np.int32)
    hsrc = np.zeros((s_n, e_halo), np.int32)
    hdst = np.zeros((s_n, e_halo), np.int32)
    hnorm = np.zeros((s_n, e_halo), np.float32)
    hgs = np.zeros((s_n, num_slots), np.int32)
    send_idx = np.zeros((s_n, s_n, h), np.int32)

    for s in range(s_n):
        src_s, dst_s, typ_s, norm_s, src_owner, own = shards[s]
        # owner-local segment: src indexes x_own directly
        l_src = (src_s[own] - s * n_per).astype(np.int32)
        l_dst = (dst_s[own] - s * n_per).astype(np.int32)
        lsrc[s], ldst[s], lnorm[s], lgs[s] = _sorted_padded_segment(
            l_src, l_dst, typ_s[own], norm_s[own], num_slots, e_loc)
        # halo segment: src indexes the received [S*H] buffer at p*H + pos
        rem = ~own
        loc = np.zeros(int(rem.sum()), np.int32)
        r_src, r_owner = src_s[rem], src_owner[rem]
        for p in range(s_n):
            if p == s:
                continue
            ids = need[s][p]                     # sorted unique remote srcs
            send_idx[p, s, :len(ids)] = ids - p * n_per
            sel = r_owner == p
            if sel.any():
                loc[sel] = p * h + np.searchsorted(ids, r_src[sel])
        h_dst = (dst_s[rem] - s * n_per).astype(np.int32)
        hsrc[s], hdst[s], hnorm[s], hgs[s] = _sorted_padded_segment(
            loc, h_dst, typ_s[rem], norm_s[rem], num_slots, e_halo)

    return HaloShardedEdges(
        lsrc=lsrc, ldst=ldst, lnorm=lnorm, lgs=lgs,
        hsrc=hsrc, hdst=hdst, hnorm=hnorm, hgs=hgs,
        send_idx=send_idx,
        num_nodes=int(num_nodes), n_per=int(n_per), halo=int(h),
        num_shards=int(s_n))


def padded_num_nodes(edges: HaloShardedEdges) -> int:
    return edges.n_per * edges.num_shards


def pad_node_array(x: jnp.ndarray, edges: HaloShardedEdges) -> jnp.ndarray:
    """Pad the leading (node) axis to ``S * n_per`` phantom rows."""
    extra = padded_num_nodes(edges) - x.shape[0]
    if extra <= 0:
        return x
    return jnp.pad(x, ((0, extra),) + ((0, 0),) * (x.ndim - 1))


def device_put_halo_edges(edges: HaloShardedEdges, mesh: Mesh) -> HaloShardedEdges:
    """Pin each shard's plan rows onto its device (leading axis sharded)."""
    from scaling_rgcn_training_tpu.parallel.mesh import put_global

    def put(a):
        return put_global(
            a, NamedSharding(mesh, P(EDGE_AXIS, *([None] * (a.ndim - 1)))))

    return HaloShardedEdges(
        lsrc=put(edges.lsrc), ldst=put(edges.ldst), lnorm=put(edges.lnorm),
        lgs=put(edges.lgs), hsrc=put(edges.hsrc), hdst=put(edges.hdst),
        hnorm=put(edges.hnorm), hgs=put(edges.hgs),
        send_idx=put(edges.send_idx),
        num_nodes=edges.num_nodes, n_per=edges.n_per, halo=edges.halo,
        num_shards=edges.num_shards)


def node_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for node-major arrays ([N_pad, ...], leading axis over the mesh)."""
    return NamedSharding(mesh, P(EDGE_AXIS))


def halo_aggregate(
    x: jnp.ndarray,
    w: jnp.ndarray,
    edges: HaloShardedEdges,
    mesh: Mesh,
    backend: Optional[str] = None,
) -> jnp.ndarray:
    """Node-sharded ``sum_e norm_e * (x[src_e] @ W[rel_e]) -> dst``.

    ``x``: [S*n_per, d] node-sharded over the mesh; returns [S*n_per, h]
    with the same sharding. The all_to_all shipping halo rows overlaps
    with the owner-local aggregation (no data dependence between them);
    only the small halo segment joins on the received buffer.
    """
    from scaling_rgcn_training_tpu.ops.rgcn_conv import take_rows

    n_per = edges.n_per

    def body(x_own, lsrc, ldst, lnorm, lgs, hsrc, hdst, hnorm, hgs,
             send_idx, w_rep):
        # x_own [n_per, d]; plan rows arrive with a leading length-1 shard axis
        send = take_rows(x_own, send_idx[0].reshape(-1))            # [S*H, d]
        send = send.reshape(edges.num_shards, edges.halo, -1)
        halo = jax.lax.all_to_all(send, EDGE_AXIS, split_axis=0,
                                  concat_axis=0, tiled=False)
        # owner-local aggregation: independent of `halo`, so the scheduler
        # can run it while the exchange is in flight
        msg = grouped_matmul(take_rows(x_own, lsrc[0]), w_rep, lgs[0],
                             backend=backend)
        out = jax.ops.segment_sum(msg * lnorm[0][:, None], ldst[0],
                                  num_segments=n_per)
        # halo segment: joins on the received rows
        hbuf = halo.reshape(edges.num_shards * edges.halo, -1)
        hmsg = grouped_matmul(take_rows(hbuf, hsrc[0]), w_rep, hgs[0],
                              backend=backend)
        return out + jax.ops.segment_sum(hmsg * hnorm[0][:, None], hdst[0],
                                         num_segments=n_per)

    shard = P(EDGE_AXIS)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(shard,) * 10 + (P(),),
        out_specs=shard,
        check_vma=False,
    )(x, edges.lsrc, edges.ldst, edges.lnorm, edges.lgs,
      edges.hsrc, edges.hdst, edges.hnorm, edges.hgs, edges.send_idx, w)


def halo_rgcn_conv(x, edges: HaloShardedEdges, params, mesh: Mesh,
                   backend: Optional[str] = None,
                   compute_dtype=None) -> jnp.ndarray:
    """Node-sharded R-GCN layer: [S*n_per, in] -> [S*n_per, out].

    Same math as ops.rgcn_conv.rgcn_conv (PyG RGCNConv semantics,
    SURVEY.md L0); the root/bias term is embarrassingly node-local.
    ``compute_dtype`` (e.g. bfloat16): the per-edge streams — the halo
    exchange itself included, halving the bytes on the wire — run in
    the low dtype while every reduction and the output stay f32, exactly
    like the single-chip mixed-precision regime.
    """
    from scaling_rgcn_training_tpu.ops.rgcn_conv import materialize_weight

    w = materialize_weight(params)
    if compute_dtype is not None:
        cd = jnp.dtype(compute_dtype)
        agg = halo_aggregate(x.astype(cd), w.astype(cd), edges, mesh,
                             backend=backend)
    else:
        agg = halo_aggregate(x, w, edges, mesh, backend=backend)
    # root/bias stays f32 (node-sized, carries the residual precision)
    return agg + x @ params.root + params.bias
