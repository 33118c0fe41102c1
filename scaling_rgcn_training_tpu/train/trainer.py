"""Trainer: summary pre-training, transfer, full-graph fine-tuning.

Functional re-design of model/modelTrainer.py:15-116:
- ``train_summaries``: ONE shared conv trunk trained sequentially over all
  summary graphs, re-initializing the embedding per graph and recording
  each trained embedding on the host Graph (modelTrainer.py:76-82);
- ``train_original``: head model on the full graph with optional embedding
  transfer (+freeze) and weight transfer (+freeze) (modelTrainer.py:84-116);
- the epoch loop evaluates on the validation split BEFORE each update step
  (modelTrainer.py:53-59) so recorded series line up with the reference's.

Everything inside an epoch is jitted; graphs are static-shaped DeviceGraph
pytrees closed over by XLA once per shape. Freezing is an optax update mask
(see optim.py) rather than torch's requires_grad surgery.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from scaling_rgcn_training_tpu.graphs.dataset import Dataset
from scaling_rgcn_training_tpu.graphs.device import DeviceGraph, build_device_graph
from scaling_rgcn_training_tpu.graphs.graph import Graph
from scaling_rgcn_training_tpu.models import heads as model_heads
from scaling_rgcn_training_tpu.train.losses import get_loss
from scaling_rgcn_training_tpu.train.metrics import (
    classification_report, evaluate, predictions)
from scaling_rgcn_training_tpu.train.optim import apply_mask, make_optimizer


def _hashable_mask(mask):
    if mask is None:
        return None
    leaves, treedef = jax.tree_util.tree_flatten(mask)
    return (tuple(leaves), treedef)


@functools.lru_cache(maxsize=64)
def _cached_fit_fn(apply_fn, loss_fn, activation, sum_graph, epochs,
                   lr, weight_d, mask_key, backend, compute_dtype=None,
                   mesh=None, aggr="mean"):
    """One jitted whole-training scan per static configuration.

    The reference re-instantiates everything per iteration (main.py:49-52),
    which here would mean recompiling the scan i times; caching on the
    static config makes iterations and repeated experiments reuse the
    compiled program (shapes are part of jit's own cache key via ``graph``).
    """
    optimizer = make_optimizer(lr, weight_d)
    mask = None if mask_key is None else jax.tree_util.tree_unflatten(
        mask_key[1], list(mask_key[0]))

    def epoch_step(graph, carry, _):
        params, opt_state, rng = carry
        if not sum_graph:
            # validation eval BEFORE the update (modelTrainer.py:53-59)
            logits = apply_fn(params, graph.edges, train=False, backend=backend,
                              compute_dtype=compute_dtype, aggr=aggr)
            acc, f1_w, f1_m = evaluate(logits, graph.x_val, graph.y_val, activation)
        else:
            acc = f1_w = f1_m = jnp.float32(0)

        rng, sub = jax.random.split(rng)

        def loss_of(p):
            logits = apply_fn(p, graph.edges, train=True, rng=sub, backend=backend,
                              compute_dtype=compute_dtype, aggr=aggr)
            return loss_fn(logits[graph.x_train], graph.y_train)

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, new_opt_state = optimizer.update(grads, opt_state, params)
        updates = apply_mask(updates, mask)
        new_params = optax.apply_updates(params, updates)
        return (new_params, new_opt_state, rng), (loss, acc, f1_w, f1_m)

    @jax.jit
    def run(params, opt_state, rng, graph):
        return jax.lax.scan(
            functools.partial(epoch_step, graph),
            (params, opt_state, rng), None, length=epochs)

    return run


class Trainer:
    """Same constructor surface as the reference Trainer (modelTrainer.py:17-24)."""

    def __init__(self, data: Dataset, hidden_l: int, epochs: int, emb_dim: int,
                 lr: float, weight_d: float, seed: int = 0,
                 backend: Optional[str] = None, num_bases: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 compute_dtype: Optional[str] = None,
                 devices: Optional[int] = None,
                 partition: str = "halo",
                 reorder: bool = False,
                 ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0,
                 plan_cache: Optional[str] = None,
                 aggr: str = "mean") -> None:
        self.data = data
        self.hidden_l = hidden_l
        self.epochs = epochs
        self.emb_dim = emb_dim
        self.lr = lr
        self.weight_d = weight_d
        self.backend = backend
        # conv aggregation: "mean" (reference parity) or "attention"
        # (SDDMM -> segment-softmax pipeline; single-device — the
        # distributed plans bake mean coefficients in, rgcn_conv raises)
        self.aggr = aggr
        if aggr != "mean" and devices and devices > 1:
            raise ValueError(
                "aggr='attention' is a single-device mode in this release")
        self.num_bases = num_bases
        self.num_blocks = num_blocks
        # mixed precision for the conv's edge streams ("bfloat16" | None)
        self.compute_dtype = compute_dtype
        # distribution: partition edges over `devices` devices ("edge" psum
        # path or "halo" node-partitioned all_to_all path); models run
        # unchanged via rgcn_conv's dispatch on the edge pytree type
        self.partition = partition if devices and devices > 1 else None
        # locality-aware halo partition: relabel nodes by clustering before
        # partitioning (parallel/reorder.py) — shrinks the halo
        # exchange on community-structured graphs
        self.reorder = bool(reorder)
        self.mesh = None
        if devices and devices > 1:
            from scaling_rgcn_training_tpu.parallel import make_mesh

            self.mesh = make_mesh(devices)
        # mid-training checkpoint/resume: every `ckpt_every` epochs the fit
        # loop persists params + optimizer state + rng + metric series under
        # ckpt_dir and resumes from there after a crash (SURVEY.md §5 —
        # greenfield; the reference loses the run on crash)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        # on-disk edge-plan cache (utils/plancache.py): skip the host-side
        # plan build on repeat runs over the same graph
        self.plan_cache = plan_cache
        self.ckpt_tag = ""              # set per iteration by the driver
        self.rng = jax.random.key(seed)
        self.sum_params = None          # trained summary model (EmbModelParams)
        self._device_graphs: Dict[int, Tuple[Graph, DeviceGraph]] = {}

    # -- helpers -----------------------------------------------------------

    def _next_rng(self) -> jax.Array:
        self.rng, sub = jax.random.split(self.rng)
        return sub

    def _device_graph(self, graph: Graph) -> DeviceGraph:
        # keyed by id(graph) WITH a strong reference to the Graph held in
        # the value: the id stays valid exactly as long as the entry lives,
        # so a gc'd Graph can never alias a stale DeviceGraph
        key = id(graph)
        hit = self._device_graphs.get(key)
        if hit is None or hit[0] is not graph:
            hit = (graph, build_device_graph(
                graph, mesh=self.mesh, partition=self.partition,
                reorder=self.reorder, plan_cache=self.plan_cache))
            self._device_graphs[key] = hit
        return hit[1]

    def _mesh_scope(self):
        if self.mesh is None:
            import contextlib

            return contextlib.nullcontext()
        from scaling_rgcn_training_tpu.parallel import use_mesh

        return use_mesh(self.mesh)

    def _pad_embedding(self, emb: jnp.ndarray, dev_graph: DeviceGraph,
                       true_n: int) -> jnp.ndarray:
        """Pad (and, under a locality reorder, permute) the node axis to
        the halo partition's S*n_per table size.

        Node axis is -2 for stacked [K, N, d] embeddings, else 0. With
        ``dev_graph.node_perm`` set, incoming rows are in true-node-id
        order and the model table is in relabeled order: row ``perm[i]``
        of the result is row ``i`` of the input."""
        from scaling_rgcn_training_tpu.graphs.device import model_num_nodes

        n_model = model_num_nodes(dev_graph)
        axis = emb.ndim - 2 if emb.ndim == 3 else 0
        if dev_graph.node_perm is not None:
            perm = np.asarray(dev_graph.node_perm)
            moved = jnp.moveaxis(emb, axis, 0)
            out = jnp.zeros((n_model,) + moved.shape[1:], emb.dtype)
            out = out.at[perm].set(moved)
            return jnp.moveaxis(out, 0, axis)
        extra = n_model - emb.shape[axis]
        if extra <= 0:
            return emb
        pad = [(0, 0)] * emb.ndim
        pad[axis] = (0, extra)
        return jnp.pad(emb, pad)

    def _init_embedding_layout(self, emb: jnp.ndarray, dev_graph: DeviceGraph,
                               true_n: int) -> jnp.ndarray:
        """Lay out a freshly-initialized embedding for this graph's model
        table. Under a locality reorder the first ``true_n`` rows are
        treated as true-node-id order and scattered to their relabeled
        rows, so a given seed assigns the same vector to the same node at
        any device count (phantom rows become zeros — they carry no edges
        or labels)."""
        if dev_graph.node_perm is None:
            return emb
        axis = emb.ndim - 2 if emb.ndim == 3 else 0
        true_rows = jax.lax.slice_in_dim(emb, 0, true_n, axis=axis)
        return self._pad_embedding(true_rows, dev_graph, true_n)

    @staticmethod
    def _export_embedding(emb: jnp.ndarray, dev_graph: DeviceGraph,
                          true_n: int) -> np.ndarray:
        """Model-table rows -> true-node-id order, phantom rows dropped
        (inverse of :meth:`_pad_embedding`'s layout)."""
        arr = np.asarray(emb)
        if dev_graph.node_perm is not None:
            return arr[np.asarray(dev_graph.node_perm)]
        return arr[:true_n]

    # -- core epoch loop (modelTrainer.py:41-74) ---------------------------

    def fit(self, params: Any, apply_fn: Callable, graph: DeviceGraph,
            loss_fn: Callable, activation: str, sum_graph: bool = True,
            mask: Any = None, verbose: bool = True,
            ckpt_path: Optional[str] = None,
            ) -> Tuple[Any, List[float], List[float], List[float], List[float]]:
        """The whole training run is ONE jitted ``lax.scan`` over epochs —
        a single device dispatch instead of one per epoch (the reference's
        Python epoch loop, modelTrainer.py:51-72, dispatches every op).
        Per-epoch metric series come back as device arrays.

        With ``ckpt_path`` (and ``ckpt_every`` > 0) the scan runs in
        ``ckpt_every``-epoch segments, persisting params + optimizer state +
        rng + metric series after each; an existing checkpoint resumes the
        run mid-training with bitwise-identical trajectory (the rng carry is
        checkpointed too)."""
        optimizer = make_optimizer(self.lr, self.weight_d)
        opt_state = optimizer.init(params)
        rng0 = self._next_rng()
        every = self.ckpt_every if (ckpt_path and self.ckpt_every > 0) else 0
        if every:
            params, losses, accs, f1_ws, f1_ms = self._fit_chunked(
                params, opt_state, rng0, apply_fn, graph, loss_fn, activation,
                sum_graph, mask, ckpt_path, every)
        else:
            run = _cached_fit_fn(
                apply_fn, loss_fn, activation, sum_graph, self.epochs,
                self.lr, self.weight_d, _hashable_mask(mask), self.backend,
                self.compute_dtype, self.mesh, self.aggr)
            with self._mesh_scope():  # ambient mesh for rgcn_conv's dispatch
                (params, _, _), (losses, accs, f1_ws, f1_ms) = run(
                    params, opt_state, rng0, graph)
        losses = [float(v) for v in np.asarray(losses)]
        if sum_graph:
            accs_l: List[float] = []
            f1w_l: List[float] = []
            f1m_l: List[float] = []
        else:
            accs_l = [float(v) for v in np.asarray(accs)]
            f1w_l = [float(v) for v in np.asarray(f1_ws)]
            f1m_l = [float(v) for v in np.asarray(f1_ms)]
        if verbose:
            for epoch in range(self.epochs):
                if not sum_graph:
                    print(f"Accuracy on validation set = {accs_l[epoch]}")
                if epoch % 10 == 0:
                    print(f"Epoch: {epoch}, Loss: {losses[epoch]:.4f}")

        return params, accs_l, losses, f1w_l, f1m_l

    def _fit_chunked(self, params, opt_state, rng, apply_fn, graph, loss_fn,
                     activation, sum_graph, mask, ckpt_path, every):
        """Run the epoch scan in ``every``-epoch segments with a checkpoint
        after each; resume from an existing checkpoint file."""
        import json
        import os

        from scaling_rgcn_training_tpu.utils.checkpoint import (
            checkpoint_exists, load_checkpoint, save_checkpoint)

        series = [np.zeros(0, np.float32) for _ in range(4)]
        start = 0
        src = ckpt_path if ckpt_path.endswith(".npz") else ckpt_path + ".npz"
        if checkpoint_exists(ckpt_path):
            state_tpl = (opt_state, jax.random.key_data(rng))
            params, (opt_state, key_data), start = load_checkpoint(
                ckpt_path, params, state_tpl)
            rng = jax.random.wrap_key_data(np.asarray(key_data))
            with open(src + ".meta.json") as fh:
                meta = json.load(fh)
            series = [np.asarray(meta["series"][k], np.float32)
                      for k in ("loss", "acc", "f1w", "f1m")]

        done = start
        while done < self.epochs:
            chunk = min(every, self.epochs - done)
            run = _cached_fit_fn(
                apply_fn, loss_fn, activation, sum_graph, chunk,
                self.lr, self.weight_d, _hashable_mask(mask), self.backend,
                self.compute_dtype, self.mesh, self.aggr)
            with self._mesh_scope():
                (params, opt_state, rng), chunk_series = run(
                    params, opt_state, rng, graph)
            series = [np.concatenate([s, np.asarray(c, np.float32)])
                      for s, c in zip(series, chunk_series)]
            done += chunk
            save_checkpoint(
                ckpt_path, params, (opt_state, jax.random.key_data(rng)),
                epoch=done,
                extra={"series": {
                    "loss": series[0].tolist(), "acc": series[1].tolist(),
                    "f1w": series[2].tolist(), "f1m": series[3].tolist()}})
        return params, series[0][:self.epochs], series[1][:self.epochs], \
            series[2][:self.epochs], series[3][:self.epochs]

    def _ckpt_path(self, stage: str) -> Optional[str]:
        if not (self.ckpt_dir and self.ckpt_every > 0):
            return None
        import os

        tag = f"_{self.ckpt_tag}" if self.ckpt_tag != "" else ""
        return os.path.join(self.ckpt_dir, f"fit_{stage}{tag}.npz")

    # -- summary pre-training (modelTrainer.py:76-82) ----------------------

    def train_summaries(self, configs: Dict[str, Any], verbose: bool = True,
                        save_path: Optional[str] = None) -> None:
        loss_fn, activation = get_loss(configs["dataset"], sum_model=True)
        sg0 = self.data.sumGraphs[0]
        params = model_heads.init_emb_model(
            self._next_rng(), sg0.num_relation_slots, self.hidden_l,
            self.data.num_classes, sg0.num_nodes, self.emb_dim,
            num_sums=len(self.data.sumGraphs),
            num_bases=self.num_bases, num_blocks=self.num_blocks)
        from scaling_rgcn_training_tpu.graphs.device import model_num_nodes

        for sg in self.data.sumGraphs:
            dg = self._device_graph(sg)
            # re-init the embedding for this summary's node count, keep trunk
            params = params._replace(
                embedding=self._init_embedding_layout(jax.random.normal(
                    self._next_rng(), (model_num_nodes(dg), self.emb_dim),
                    jnp.float32), dg, sg.num_nodes))
            params, *_ = self.fit(
                params, model_heads.apply_emb_model, dg,
                loss_fn, activation, sum_graph=True, verbose=verbose)
            # drop halo-partition phantom rows (and undo any locality
            # relabeling) before recording: transfer tricks index true
            # node ids only
            sg.embedding = self._export_embedding(params.embedding, dg,
                                                  sg.num_nodes)
        self.sum_params = params
        if save_path:
            from scaling_rgcn_training_tpu.utils.checkpoint import save_transfer_state

            save_transfer_state(
                save_path, (params.rgcn1, params.rgcn2),
                [sg.embedding for sg in self.data.sumGraphs])

    def load_summaries(self, path: str) -> None:
        """Resume the transfer stage from a ``save_transfer_state`` file:
        the on-disk equivalent of the reference's in-memory clones
        (modelTrainer.py:28-35,82); ``train_original`` can then run without
        re-pretraining."""
        from scaling_rgcn_training_tpu.utils.checkpoint import load_transfer_state
        from scaling_rgcn_training_tpu.ops import init_rgcn_layer

        template = (
            init_rgcn_layer(jax.random.key(0), self.data.orgGraph.num_relation_slots,
                            self.emb_dim, self.hidden_l,
                            num_bases=self.num_bases, num_blocks=self.num_blocks),
            init_rgcn_layer(jax.random.key(0), self.data.orgGraph.num_relation_slots,
                            self.hidden_l, self.data.num_classes,
                            num_bases=self.num_bases, num_blocks=self.num_blocks),
        )
        (rgcn1, rgcn2), embs = load_transfer_state(path, template)
        assert len(embs) == len(self.data.sumGraphs), (
            f"checkpoint has {len(embs)} summary embeddings, dataset has "
            f"{len(self.data.sumGraphs)} summary graphs")
        for sg, emb in zip(self.data.sumGraphs, embs):
            sg.embedding = np.asarray(emb)
        sg0 = self.data.sumGraphs[0]
        self.sum_params = model_heads.init_emb_model(
            jax.random.key(0), sg0.num_relation_slots, self.hidden_l,
            self.data.num_classes, sg0.num_nodes, self.emb_dim,
            num_bases=self.num_bases, num_blocks=self.num_blocks
        )._replace(rgcn1=rgcn1, rgcn2=rgcn2)

    # -- weight transfer (modelTrainer.py:26-39) ---------------------------

    def transfer_weights(self, org_params: Any) -> Any:
        assert self.sum_params is not None, "train_summaries must run first"
        return org_params._replace(
            rgcn1=self.sum_params.rgcn1, rgcn2=self.sum_params.rgcn2)

    # -- full-graph training (modelTrainer.py:84-116) ----------------------

    def train_original(self, head: str, configs: Dict[str, Any], exp: str,
                       verbose: bool = True) -> Dict[str, Any]:
        from scaling_rgcn_training_tpu.train.transfer import EMBEDDING_TRICKS

        from scaling_rgcn_training_tpu.graphs.device import model_num_nodes

        og = self.data.orgGraph
        dev_graph = self._device_graph(og)
        init_fn, apply_fn = model_heads.HEADS[head]
        num_sums = configs.get("num_sums", 1)
        params = init_fn(
            self._next_rng(), og.num_relation_slots, self.hidden_l,
            self.data.num_classes, model_num_nodes(dev_graph), self.emb_dim,
            num_sums=num_sums, num_bases=self.num_bases, num_blocks=self.num_blocks)
        params = params._replace(embedding=self._init_embedding_layout(
            params.embedding, dev_graph, og.num_nodes))

        mask = jax.tree_util.tree_map(lambda _: True, params)

        if exp != "baseline" and configs.get("e_trans", False):
            trick = EMBEDDING_TRICKS[head]
            embedding = trick(og, self.data.sumGraphs, self.emb_dim, self._next_rng())
            embedding = self._pad_embedding(embedding, dev_graph, og.num_nodes)
            params = params._replace(embedding=embedding)
            if configs.get("e_freeze", True):
                mask = mask._replace(embedding=False)
            if verbose:
                print("Loaded pre trained embedding")

        if exp != "baseline" and configs.get("w_trans", False):
            params = self.transfer_weights(params)
            if not configs.get("w_grad", True):
                freeze = jax.tree_util.tree_map(lambda _: False, params.rgcn1)
                mask = mask._replace(
                    rgcn1=freeze, rgcn2=jax.tree_util.tree_map(lambda _: False, params.rgcn2))
            if verbose:
                print("weight transfer done")

        loss_fn, activation = get_loss(configs["dataset"], sum_model=False)

        if verbose:
            print("Training on Orginal Graph...")
        params, accs, losses, f1_ws, f1_ms = self.fit(
            params, apply_fn, dev_graph, loss_fn, activation,
            sum_graph=False, mask=mask, verbose=verbose,
            ckpt_path=self._ckpt_path(f"{configs['dataset']}_{exp}"))

        test_acc, test_f1_w, test_f1_m = self.evaluate_test(
            params, apply_fn, dev_graph, activation, report=verbose)
        if verbose:
            print("ACC ON TEST SET = ", test_acc)

        return {
            "accuracy": accs, "loss": losses,
            "f1 weighted": f1_ws, "f1 macro": f1_ms,
            "test_acc": test_acc, "test_f1_weighted": test_f1_w,
            "test_f1_macro": test_f1_m, "params": params, "mask": mask,
        }

    def evaluate_test(self, params, apply_fn, graph: DeviceGraph,
                      activation: str, report: bool = False) -> Tuple[float, float, float]:
        """Test-split metrics (+ optional per-class report, modelTrainer.py:112-114).

        Cost note (distributed runs): the metric math itself stays on
        device (``evaluate`` reduces to scalars), but this path runs ONCE
        per training run outside the jitted scan, so XLA may gather the
        node-sharded ``[N_pad, C]`` logits to index ``x_test`` — at AM
        scale that is ~51 MB once per run; ``report=True`` additionally
        pulls predictions to host for the report. The per-epoch validation
        eval does NOT do this: it runs inside the jitted scan and carries
        scalars only.
        """
        with self._mesh_scope():
            logits = apply_fn(params, graph.edges, train=False, backend=self.backend,
                              compute_dtype=self.compute_dtype, aggr=self.aggr)
        acc, f1_w, f1_m = evaluate(logits, graph.x_test, graph.y_test, activation)
        if report:
            pred = np.asarray(predictions(logits, activation))[np.asarray(graph.x_test)]
            print(classification_report(np.asarray(graph.y_test), pred))
        return float(acc), float(f1_w), float(f1_m)


def count_trainable_parameters(params: Any, mask: Any,
                               sum_graphs: Optional[List[Graph]] = None) -> int:
    """Reference results.py:29-37: trainable params + summary embeddings."""
    total = 0
    for leaf, m in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(mask)):
        if m:
            total += int(np.prod(leaf.shape))
    if sum_graphs:
        for sg in sum_graphs:
            if sg.embedding is not None:
                total += int(sg.embedding.shape[0] * sg.embedding.shape[1])
    return total
