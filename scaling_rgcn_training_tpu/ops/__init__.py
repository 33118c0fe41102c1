"""Sparse relational ops.

The center of the framework: a per-relation sparse aggregation (the math of
PyG ``RGCNConv`` as used by the reference at model/layers.py:15-16,21-23)
re-designed as a few large XLA operations:

- edges are stored sorted by relation so the per-edge transform is one
  grouped matmul,
- per-(node, relation) mean normalization is a precomputed static per-edge
  coefficient,
- aggregation is a single segment-sum scatter keyed on destination node,
- basis / block-diagonal weight decompositions are first-class options.
"""

from scaling_rgcn_training_tpu.ops.grouped_matmul import grouped_matmul
from scaling_rgcn_training_tpu.ops.rgcn_conv import (
    RelEdges,
    RGCNLayerParams,
    build_rel_edges,
    rgcn_conv,
    init_rgcn_layer,
    materialize_weight,
)
from scaling_rgcn_training_tpu.ops.sddmm import (
    attention_aggregate, sddmm, sddmm_rel, segment_softmax)

__all__ = [
    "grouped_matmul",
    "RelEdges",
    "RGCNLayerParams",
    "build_rel_edges",
    "rgcn_conv",
    "init_rgcn_layer",
    "materialize_weight",
    "attention_aggregate",
    "sddmm",
    "sddmm_rel",
    "segment_softmax",
]
