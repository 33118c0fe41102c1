"""The per-relation sparse graph convolution (R-GCN message passing).

Reproduces the math of PyG ``RGCNConv`` exactly as the reference uses it
(model/layers.py:15-16,21-23 with ``num_bases=None``, ``num_blocks=None``,
default ``aggr='mean'``, ``root_weight=True``, ``bias=True``):

    out_i = x_i @ root + bias + sum_r ( mean_{j in N_r(i)} x_j ) @ weight[r]

where ``N_r(i)`` are sources of edges of relation ``r`` arriving at ``i``.

Dataflow (none of this mirrors PyG's R masked passes):

- Edges are preprocessed ONCE per graph into :class:`RelEdges`: sorted by
  (relation, dst), padded to a static size, with the per-edge
  ``1/deg_r(dst)`` mean coefficient precomputed (pads carry ``norm=0``).
- The forward is one of two plain XLA dataflows, picked from the shapes
  (``select_mode``):
  * ``edge`` — gather ``x[src]`` -> one grouped matmul over the
    relation-contiguous rows (ops/grouped_matmul.py) -> scale ->
    ``segment_sum`` onto dst;
  * ``prematmul`` — transform first: ``Z = X @ [W_0 .. W_R]`` as one dense
    matmul, then gather the ``d_out``-wide rows ``Z[src, rel]`` -> scale ->
    ``segment_sum``.
- The backward is JAX's autodiff of those same operations: the gathers
  transpose to scatter-adds (in float32, ``take_rows``), the grouped
  matmul to its two transposes (no per-edge ``[E, d_in, d_out]`` outer
  product is ever formed).
- Basis / block-diagonal decompositions (features the reference's op API
  exposes but leaves disabled) are first-class: weights are stored
  decomposed and materialized to ``[R, in, out]`` on the fly (tiny).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from scaling_rgcn_training_tpu.ops.grouped_matmul import (
    aligned_group_layout, grouped_matmul)


class RelEdges(NamedTuple):
    """Static-shaped, relation-sorted edge arrays for one graph.

    ``src``/``dst``/``rel``: int32 [E_pad]; ``norm``: float32 [E_pad] (the
    ``1/deg_r(dst)`` mean coefficient, 0 for padding rows); ``group_sizes``:
    int32 [num_slots] rows per relation slot. Every slot is padded to a
    multiple of ``grouped_matmul.TILE`` rows (the tile-aligned layout the
    grouped matmul needs); the remaining padding goes to the final slot,
    which the reference keeps empty — see ``Graph.num_relation_slots``.
    ``num_nodes`` is static.
    """

    src: jnp.ndarray
    dst: jnp.ndarray
    norm: jnp.ndarray
    rel: jnp.ndarray
    group_sizes: jnp.ndarray
    num_nodes: int


jax.tree_util.register_pytree_node(
    RelEdges,
    lambda e: ((e.src, e.dst, e.norm, e.rel, e.group_sizes), (e.num_nodes,)),
    lambda aux, ch: RelEdges(*ch, num_nodes=aux[0]),
)


def build_rel_edges(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_type: np.ndarray,
    num_nodes: int,
    num_slots: int,
    pad_to_multiple: int = 512,
    cache_dir: Optional[str] = None,
) -> RelEdges:
    """Preprocess a raw edge list into the static device layout.

    Host-side, runs once per graph. Sorts edges by (relation, dst) —
    relation-contiguity feeds the grouped matmul; dst-sortedness within
    each relation keeps the scatter's access pattern monotonic. The row
    count is a multiple of ``pad_to_multiple`` and of the grouped matmul's
    tile.

    ``cache_dir``: persist/load the finished plan on disk keyed by a
    content hash of the inputs (utils/plancache.py).
    """
    from scaling_rgcn_training_tpu.utils.plancache import get_or_build, to_device

    if cache_dir:
        return get_or_build(
            cache_dir, "reledges", (edge_src, edge_dst, edge_type),
            (num_nodes, num_slots, pad_to_multiple),
            lambda: _build_rel_edges_host(edge_src, edge_dst, edge_type,
                                          num_nodes, num_slots,
                                          pad_to_multiple))
    return to_device(_build_rel_edges_host(
        edge_src, edge_dst, edge_type, num_nodes, num_slots, pad_to_multiple))


def _build_rel_edges_host(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_type: np.ndarray,
    num_nodes: int,
    num_slots: int,
    pad_to_multiple: int = 512,
) -> RelEdges:
    """The host-side build: every array leaf is numpy (cacheable without an
    accelerator round trip); ``build_rel_edges`` converts at the boundary."""
    edge_src = np.asarray(edge_src, np.int32)
    edge_dst = np.asarray(edge_dst, np.int32)
    edge_type = np.asarray(edge_type, np.int32)

    order = np.lexsort((edge_dst, edge_type))
    src, dst, typ = edge_src[order], edge_dst[order], edge_type[order]

    # per-(dst, relation) in-degree -> mean coefficient per edge
    keys = typ.astype(np.int64) * num_nodes + dst.astype(np.int64)
    uniq, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    norm = (1.0 / counts[inv]).astype(np.float32)

    pos, group_sizes = aligned_group_layout(typ, num_slots, pad_to_multiple)
    return RelEdges(*_scatter_rows(pos, group_sizes, src, dst, norm),
                    group_sizes=group_sizes, num_nodes=int(num_nodes))


def _scatter_rows(pos, group_sizes, src, dst, norm):
    """(src, dst, norm, rel) laid out at rows ``pos`` of the aligned layout;
    padding rows get src = dst = 0 and norm = 0."""
    rows = int(group_sizes.sum())
    out_src = np.zeros(rows, np.int32)
    out_dst = np.zeros(rows, np.int32)
    out_norm = np.zeros(rows, np.float32)
    out_src[pos], out_dst[pos], out_norm[pos] = src, dst, norm
    rel = np.repeat(np.arange(len(group_sizes), dtype=np.int32), group_sizes)
    return out_src, out_dst, out_norm, rel


class RGCNLayerParams(NamedTuple):
    """One R-GCN layer's parameters, optionally decomposed.

    - full:       ``weight [R, in, out]``, ``comp=None``
    - basis:      ``weight [B, in, out]`` (bases), ``comp [R, B]``
    - block-diag: ``weight [R, nb, in/nb, out/nb]``, ``comp=None``
    ``root [in, out]``, ``bias [out]`` always dense (PyG parity: the
    reference reads/writes exactly weight/root/bias per layer when
    transferring, model/modelTrainer.py:28-35).
    """

    weight: jnp.ndarray
    root: jnp.ndarray
    bias: jnp.ndarray
    comp: Optional[jnp.ndarray] = None


def materialize_weight(params: RGCNLayerParams) -> jnp.ndarray:
    """-> dense ``[R, in, out]`` relation weights from any decomposition."""
    w = params.weight
    if params.comp is not None:  # basis decomposition
        return jnp.einsum("rb,bio->rio", params.comp, w, preferred_element_type=jnp.float32).astype(w.dtype)
    if w.ndim == 4:  # block-diagonal [R, nb, i/nb, o/nb] -> [R, in, out]
        r, nb, bi, bo = w.shape
        eye = jnp.eye(nb, dtype=w.dtype)
        # place block b on the diagonal: out[r, b*bi:(b+1)*bi, b*bo:(b+1)*bo] = w[r, b]
        dense = jnp.einsum("rbio,bc->rbico", w, eye)
        return dense.reshape(r, nb * bi, nb * bo)
    return w


def init_rgcn_layer(
    key: jax.Array,
    num_slots: int,
    in_dim: int,
    out_dim: int,
    num_bases: Optional[int] = None,
    num_blocks: Optional[int] = None,
    dtype=jnp.float32,
) -> RGCNLayerParams:
    """Initialization matching the reference's distributions.

    - relation weights: torch ``kaiming_uniform_(mode='fan_in')`` applied to
      the ``[R, in, out]`` tensor (model/layers.py:17-18): bound
      ``sqrt(6 / (in * out))`` (torch's fan_in for a 3D tensor is
      ``size(1) * prod(size()[2:])``).
    - root: PyG glorot, bound ``sqrt(6 / (in + out))``.
    - bias: zeros (PyG default).
    """
    k_w, k_r, k_c = jax.random.split(key, 3)
    if num_blocks is not None:
        assert in_dim % num_blocks == 0 and out_dim % num_blocks == 0, (
            "block-diagonal decomposition needs in/out divisible by num_blocks"
        )
        w_shape = (num_slots, num_blocks, in_dim // num_blocks, out_dim // num_blocks)
        fan = w_shape[1] * w_shape[2] * w_shape[3]
        comp = None
    elif num_bases is not None:
        w_shape = (num_bases, in_dim, out_dim)
        fan = in_dim * out_dim
        comp = jax.random.uniform(
            k_c, (num_slots, num_bases),
            minval=-np.sqrt(6.0 / (num_slots + num_bases)),
            maxval=np.sqrt(6.0 / (num_slots + num_bases)), dtype=dtype,
        )
    else:
        w_shape = (num_slots, in_dim, out_dim)
        fan = in_dim * out_dim
        comp = None
    bound_w = np.sqrt(6.0 / fan)
    bound_r = np.sqrt(6.0 / (in_dim + out_dim))
    return RGCNLayerParams(
        weight=jax.random.uniform(k_w, w_shape, minval=-bound_w, maxval=bound_w, dtype=dtype),
        root=jax.random.uniform(k_r, (in_dim, out_dim), minval=-bound_r, maxval=bound_r, dtype=dtype),
        bias=jnp.zeros((out_dim,), dtype),
        comp=comp,
    )


def select_mode(num_nodes: int, num_slots: int, num_edges: int,
                d_in: int, d_out: int) -> str:
    """Pick the forward dataflow from the layer's shapes (see module doc).

    ``prematmul`` trades the ``[E, d_in]`` source gather for a dense
    ``[N * slots, d_out]`` table; it pays while that table is at most twice
    the gather's size. Tuned on float32 timings of an H100 at the bench
    and AM shapes (scripts/time_conv_modes.py, PERF.md); in bfloat16 the
    edge dataflow is ahead by 5% at the bench's first layer, which this
    rule gives up."""
    z_elems = num_nodes * num_slots * d_out
    if d_out < d_in and z_elems <= 2 * num_edges * d_in:
        return "prematmul"
    return "edge"


def take_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``table[idx]`` whose gradient scatter-adds in float32.

    Autodiff of a gather scatter-adds the cotangent in the table's dtype;
    for a bfloat16 table that accumulates a node's in-edges in bfloat16.
    Here the sum runs in float32 and is rounded once."""
    return _take_rows(table, idx, (table.shape[0], jnp.dtype(table.dtype)))


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _take_rows(table, idx, table_meta):
    return jnp.take(table, idx, axis=0)


def _take_rows_fwd(table, idx, table_meta):
    return _take_rows(table, idx, table_meta), idx


def _take_rows_bwd(table_meta, idx, ct):
    rows, dtype = table_meta
    dtable = jax.ops.segment_sum(ct.astype(jnp.float32), idx,
                                 num_segments=rows)
    return dtable.astype(dtype), np.zeros(idx.shape, jax.dtypes.float0)


_take_rows.defvjp(_take_rows_fwd, _take_rows_bwd)


def relational_aggregate(x, w, edges: RelEdges, mode: str = "edge",
                         backend: Optional[str] = None):
    """sum_e norm_e * (x[src_e] @ W[rel_e]) scattered onto dst: [N, d_out].

    Low-precision inputs stream in their own dtype; the scale, the
    scatter and the result are float32."""
    n = edges.num_nodes
    d_out = w.shape[2]
    acc = jnp.float32 if x.dtype in (jnp.bfloat16, jnp.float16) else x.dtype
    if mode == "prematmul":
        slots = w.shape[0]
        # ONE flat matmul: [N, d] @ [d, slots*h] -> [N*slots, h] in src-major
        # layout, so the gather key is src*slots + rel
        w_flat = jnp.swapaxes(w, 0, 1).reshape(w.shape[1], slots * d_out)
        z = jnp.dot(x, w_flat, preferred_element_type=jnp.float32
                    ).astype(x.dtype).reshape(n * slots, d_out)
        msg = take_rows(z, edges.src * slots + edges.rel)
    elif mode == "edge":
        msg = grouped_matmul(take_rows(x, edges.src), w, edges.group_sizes,
                             backend=backend)
    else:
        raise ValueError(f"unknown aggregation mode {mode!r}")
    msg = msg * edges.norm[:, None].astype(acc)
    return jax.ops.segment_sum(msg, edges.dst, num_segments=n).astype(acc)


def rgcn_conv(
    x: jnp.ndarray,
    edges: RelEdges,
    params: RGCNLayerParams,
    backend: str | None = None,
    mode: str = "auto",
    compute_dtype=None,
    aggr: str = "mean",
) -> jnp.ndarray:
    """Apply one R-GCN layer: ``[N, in] -> [N, out]``.

    Jit-safe: everything static-shaped. Padding rows are killed by
    ``norm == 0``, so the extra rows in the final (empty) relation slot
    never contribute.

    ``aggr``: ``"mean"`` (PyG ``RGCNConv`` parity, the default) or
    ``"attention"`` — data-dependent attention over each node's incoming
    edges via the SDDMM -> segment-softmax -> weighted-scatter pipeline
    (ops/sddmm.py ``attention_aggregate``; a capability the reference's
    PyG op does not offer, SURVEY.md §7.5's other op-library half).

    ``mode``: ``"auto"`` (``select_mode``), ``"edge"`` or ``"prematmul"``.

    ``compute_dtype`` (e.g. ``jnp.bfloat16``): mixed precision — the wide
    per-edge streams (source-feature gathers, grouped matmuls) run in the
    low dtype, halving the dominant memory traffic, while every reduction
    (segment sums, matmul accumulation, dw) and the output stay float32.
    Params are stored f32 throughout.

    Dispatch: when ``edges`` is a ``parallel.ShardedRelEdges`` (edge lists
    partitioned over a device mesh), the SPMD path runs instead — models
    never need to know whether they're distributed.
    """
    if type(edges).__name__ in ("ShardedRelEdges", "HaloShardedEdges") \
            and aggr != "mean":
        raise ValueError(
            "aggr='attention' is a single-device mode in this release: the "
            "distributed aggregation paths implement the mean-normalized "
            "conv (their edge coefficients are baked into the static halo "
            "plans; attention weights are data-dependent)")
    if type(edges).__name__ == "ShardedRelEdges":
        from scaling_rgcn_training_tpu.parallel import current_mesh, sharded_rgcn_conv

        mesh = current_mesh()
        assert mesh is not None, (
            "rgcn_conv got sharded edges outside a parallel.use_mesh(...) scope")
        return sharded_rgcn_conv(x, edges, params, mesh, backend=backend,
                                 compute_dtype=compute_dtype)
    if type(edges).__name__ == "HaloShardedEdges":
        from scaling_rgcn_training_tpu.parallel import current_mesh, halo_rgcn_conv

        mesh = current_mesh()
        assert mesh is not None, (
            "rgcn_conv got halo-sharded edges outside a parallel.use_mesh(...) scope")
        return halo_rgcn_conv(x, edges, params, mesh, backend=backend,
                              compute_dtype=compute_dtype)

    w = materialize_weight(params)
    if aggr == "attention":
        from scaling_rgcn_training_tpu.ops.sddmm import attention_aggregate

        if compute_dtype is not None:
            cd = jnp.dtype(compute_dtype)
            agg = attention_aggregate(x.astype(cd), w.astype(cd),
                                      params.root.astype(cd), edges,
                                      backend=backend)
        else:
            agg = attention_aggregate(x, w, params.root, edges,
                                      backend=backend)
        return agg + x @ params.root + params.bias
    assert aggr == "mean", f"unknown aggr {aggr!r}"
    if mode == "auto":
        mode = select_mode(edges.num_nodes, w.shape[0], edges.src.shape[0],
                           w.shape[1], w.shape[2])
    if compute_dtype is not None:
        cd = jnp.dtype(compute_dtype)
        agg = relational_aggregate(x.astype(cd), w.astype(cd), edges, mode,
                                   backend)
    else:
        agg = relational_aggregate(x, w, edges, mode, backend)
    # root/bias term stays f32: it is node-sized (cheap) and carries the
    # residual path's precision
    return agg + x @ params.root + params.bias
