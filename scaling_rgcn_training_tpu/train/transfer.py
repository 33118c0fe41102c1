"""Summary -> full-graph embedding transfer ("embedding tricks").

Reference model/embeddingTricks.py:8-49: per summary graph, build an
``[N_org, d]`` tensor initialized ``torch.rand`` (U[0,1)), then overwrite
row ``idx(orgNode)`` with the trained embedding row of its summary node;
fuse the per-summary tensors by sum / concat / stack.

Vectorized: the reference's per-node Python dict loop (hot loop #2 in
SURVEY.md §3.3) becomes one precomputed index pair + a vectorized scatter —
``base.at[org_idx].set(sum_emb[sum_idx])``.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from scaling_rgcn_training_tpu.graphs.graph import Graph
from scaling_rgcn_training_tpu.graphs.processing import mapping_index_arrays


def build_transfer_tensors(org_graph: Graph, sum_graphs: List[Graph],
                           emb_dim: int, rng: jax.Array) -> List[jnp.ndarray]:
    """One ``[N_org, d]`` tensor per summary graph (embeddingTricks.py:8-25)."""
    tensors = []
    for i, sg in enumerate(sum_graphs):
        assert sg.embedding is not None, (
            f"summary graph {sg.name} has no trained embedding; run train_summaries first")
        base = jax.random.uniform(
            jax.random.fold_in(rng, i), (org_graph.num_nodes, emb_dim), jnp.float32)
        org_idx, sum_idx = mapping_index_arrays(org_graph, sg)
        emb = jnp.asarray(sg.embedding)
        tensors.append(base.at[jnp.asarray(org_idx)].set(emb[jnp.asarray(sum_idx)]))
    return tensors


def sum_embeddings(org_graph, sum_graphs, emb_dim, rng) -> jnp.ndarray:
    """[N, d] — elementwise sum over summaries (embeddingTricks.py:45-49)."""
    t = build_transfer_tensors(org_graph, sum_graphs, emb_dim, rng)
    return jnp.sum(jnp.stack(t), axis=0)


def concat_embeddings(org_graph, sum_graphs, emb_dim, rng) -> jnp.ndarray:
    """[N, K*d] — feature concat (embeddingTricks.py:37-43)."""
    return jnp.concatenate(
        build_transfer_tensors(org_graph, sum_graphs, emb_dim, rng), axis=-1)


def stack_embeddings(org_graph, sum_graphs, emb_dim, rng) -> jnp.ndarray:
    """[K, N, d] — stacked for the attention head (embeddingTricks.py:28-35)."""
    return jnp.stack(build_transfer_tensors(org_graph, sum_graphs, emb_dim, rng))


EMBEDDING_TRICKS = {
    "summation": sum_embeddings,
    "mlp": concat_embeddings,
    "attention": stack_embeddings,
    "baseline": None,
}
