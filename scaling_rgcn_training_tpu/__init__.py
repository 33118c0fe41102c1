"""scaling_rgcn_training_tpu — a relational message-passing framework in JAX.

Reimplements the capabilities of tiddoloos/Scaling-RGCN-training (R-GCN entity
typing on RDF knowledge graphs, scaled via summary-graph pre-training and
embedding/weight transfer) as an idiomatic JAX/XLA/shard_map framework:

- ``graphs``   — N-Triples parsing, vocab/label encoding, dataset assembly,
                 summary-graph construction (attribute / bisimulation / dummy).
- ``ops``      — the per-relation sparse conv (R-GCN message passing) with
                 a tiled grouped-matmul transform and an XLA segment-sum;
                 basis/block-diagonal decomposition.
- ``models``   — the three transfer heads (summation / MLP / multi-head
                 attention) as pure-function + param-pytree models.
- ``train``    — fully-jitted training loops (lax.scan over epochs), losses,
                 metrics, summary->full-graph transfer machinery.
- ``parallel`` — device mesh management, edge-partitioned execution via
                 shard_map, multi-host initialization.
- ``utils``    — results/reporting (JSON schema compatible with the
                 reference), timing, config checks, checkpointing.
"""

__version__ = "0.1.0"
