"""SDDMM — sampled dense-dense matmul over graph edges.

Computes per-edge scores from dense node features without materializing
the N x N product (SURVEY.md §7 step 5 lists SDDMM alongside SpMM as the
kernel pair of the op library; the reference itself never needs it because
its only attention is the K-summary MHA, model/layers.py:53-66 — SDDMM is
what graph-level attention, e.g. a GAT/relational-transformer extension of
the trunk, requires):

    sddmm:       s_e = <x[src_e], y[dst_e]>                      [E]
    sddmm_rel:   s_e = <x[src_e] @ W[rel_e], y[dst_e]>           [E]

Dataflow: two streaming gathers feed a rowwise multiply-reduce, which XLA
can fuse into the gather epilogue, so the op moves 2*E*d bytes with no
intermediate [E, d] round trip through device memory. The relational
variant routes the per-edge transform through the same grouped matmul as
the conv, reusing the relation-sorted layout of
:class:`~.rgcn_conv.RelEdges`.

``segment_softmax`` turns scores into per-destination attention weights
(the scatter-side companion: max/sum segment reductions over dst), and
:func:`attention_aggregate` composes the full pipeline — the framework
consumer, exposed as ``rgcn_conv(..., aggr="attention")``
(ops/rgcn_conv.py) with dense-oracle golden + gradient tests
(tests/test_sddmm.py).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from scaling_rgcn_training_tpu.ops.grouped_matmul import grouped_matmul
from scaling_rgcn_training_tpu.ops.rgcn_conv import RelEdges, take_rows


def sddmm(x: jnp.ndarray, y: jnp.ndarray, src: jnp.ndarray,
          dst: jnp.ndarray) -> jnp.ndarray:
    """Per-edge inner products ``<x[src_e], y[dst_e]>`` -> float [E]."""
    xs = jnp.take(x, src, axis=0)
    yd = jnp.take(y, dst, axis=0)
    return jnp.sum(xs.astype(jnp.float32) * yd.astype(jnp.float32), axis=-1)


def sddmm_rel(x: jnp.ndarray, y: jnp.ndarray, w: jnp.ndarray,
              edges: RelEdges, backend: Optional[str] = None) -> jnp.ndarray:
    """Relational SDDMM: ``<x[src_e] @ W[rel_e], y[dst_e]>`` -> float [E].

    ``w: [num_slots, d_x, d_y]``; edge rows are relation-sorted so the
    per-edge transform is one grouped matmul, like the conv.
    """
    xs = jnp.take(x, edges.src, axis=0)
    z = grouped_matmul(xs, w, edges.group_sizes, backend=backend)
    yd = jnp.take(y, edges.dst, axis=0)
    return jnp.sum(z.astype(jnp.float32) * yd.astype(jnp.float32), axis=-1)


def attention_aggregate(x: jnp.ndarray, w: jnp.ndarray, root: jnp.ndarray,
                        edges: RelEdges,
                        backend: Optional[str] = None) -> jnp.ndarray:
    """Relational-attention aggregation: the SDDMM -> segment-softmax ->
    weighted-scatter pipeline as one op (the framework consumer of this
    module; exposed as ``rgcn_conv(..., aggr="attention")``).

    Replaces the conv's fixed mean coefficients with data-dependent
    attention over each node's incoming edges (a relational-transformer
    aggregation; parameter-free beyond the layer's own weights):

        m_e     = x[src_e] @ W[rel_e]                 (per-edge message)
        s_e     = <m_e, x[dst_e] @ root> / sqrt(d_out)  (SDDMM score)
        alpha_e = softmax over {e : dst_e = i} of s_e  (segment softmax)
        out_i   = sum_e alpha_e * m_e                  (weighted scatter)

    Padding rows (``edges.norm == 0``) are masked out of the softmax and
    contribute zero. Coefficients are data-dependent, so this runs the
    gather/grouped-matmul dataflow; returns f32.
    """
    n = edges.num_nodes
    d_out = w.shape[2]
    msg = grouped_matmul(take_rows(x, edges.src), w, edges.group_sizes,
                         backend=backend)                         # [E, d_out]
    keys = jnp.dot(x, root, preferred_element_type=jnp.float32
                   ).astype(x.dtype)                              # [N, d_out]
    kd = take_rows(keys, edges.dst)
    scores = jnp.sum(msg.astype(jnp.float32) * kd.astype(jnp.float32),
                     axis=-1) * jax.lax.rsqrt(jnp.float32(d_out))
    alpha = segment_softmax(scores, edges.dst, n, mask=edges.norm)
    return jax.ops.segment_sum(msg.astype(jnp.float32) * alpha[:, None],
                               edges.dst, num_segments=n)


def segment_softmax(scores: jnp.ndarray, segment_ids: jnp.ndarray,
                    num_segments: int,
                    mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Softmax of ``scores`` within each segment (e.g. per dst node).

    ``mask`` (float 0/1 per edge, e.g. ``edges.norm > 0``) excludes padding
    rows; masked rows return weight 0. Numerically stable via per-segment
    max subtraction.
    """
    if mask is not None:
        scores = jnp.where(mask > 0, scores, -jnp.inf)
    seg_max = jax.ops.segment_max(scores, segment_ids, num_segments=num_segments)
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, 0.0)
    shifted = scores - jnp.take(seg_max, segment_ids)
    expd = jnp.where(jnp.isfinite(shifted), jnp.exp(shifted), 0.0)
    denom = jax.ops.segment_sum(expd, segment_ids, num_segments=num_segments)
    denom = jnp.where(denom > 0, denom, 1.0)
    return expd / jnp.take(denom, segment_ids)
