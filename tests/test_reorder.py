"""Locality-aware node reordering (parallel/reorder.py) + its trainer
integration: the halo partition's exchange traffic shrinks on clustered graphs
and training results are invariant to the relabeling.
"""

import numpy as np
import pytest
import jax

from scaling_rgcn_training_tpu.parallel import (
    locality_reorder, edge_cut_fraction, halo_partition_edges)


def _sbm_graph(seed=0, n=4000, e=40000, k=16, p_in=0.9):
    """Stochastic-block-model-ish graph with scrambled (IRI-like) ids."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, k, n)
    members = [np.flatnonzero(comm == c) for c in range(k)]
    src = np.empty(e, np.int64)
    dst = np.empty(e, np.int64)
    intra = rng.random(e) < p_in
    ci = rng.integers(0, k, int(intra.sum()))
    src[intra] = [members[c][rng.integers(len(members[c]))] for c in ci]
    dst[intra] = [members[c][rng.integers(len(members[c]))] for c in ci]
    m = int((~intra).sum())
    src[~intra] = rng.integers(0, n, m)
    dst[~intra] = rng.integers(0, n, m)
    return src.astype(np.int32), dst.astype(np.int32), n


def test_reorder_is_a_permutation():
    src, dst, n = _sbm_graph()
    perm = locality_reorder(src, dst, n)
    assert perm.shape == (n,)
    assert len(np.unique(perm)) == n
    assert perm.min() == 0 and perm.max() == n - 1


def test_reorder_shrinks_edge_cut_on_clustered_graph():
    src, dst, n = _sbm_graph()
    perm = locality_reorder(src, dst, n)
    before = edge_cut_fraction(src, dst, n, 8)
    after = edge_cut_fraction(src, dst, n, 8, perm)
    assert after < before / 3, (before, after)


def test_reorder_shrinks_halo_buffer():
    """The halo buffer is a MAX over (reader, owner) pairs, so it is
    dominated by communities straddling shard boundaries — plain
    label-sorted numbering straddles nearly every community (even the
    ground-truth community order only reaches halo=216 on this graph).
    The shard-aware packing (num_shards) removes the straddles and beats
    the 2x bound with room to spare (measured: 376 -> 112)."""
    src, dst, n = _sbm_graph(seed=1)
    typ = np.random.default_rng(2).integers(0, 6, len(src)).astype(np.int32)
    he0 = halo_partition_edges(src, dst, typ, n, 7, 8, pad_to_multiple=64)
    perm = locality_reorder(src, dst, n, num_shards=8)
    he1 = halo_partition_edges(perm[src], perm[dst], typ, n, 7, 8,
                               pad_to_multiple=64)
    assert he1.halo < he0.halo / 2, (he0.halo, he1.halo)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_trainer_reorder_matches_single_device(tmp_path):
    """Reordered 8-device halo training tracks the single-device loss
    curve: the relabeling is pure dataflow, and the seeded embedding init
    is laid out so node i gets the same vector at any device count."""
    import os

    from scaling_rgcn_training_tpu.graphs.dataset import Dataset
    from scaling_rgcn_training_tpu.graphs.synthetic import ensure_synthetic_dataset
    from scaling_rgcn_training_tpu.train.trainer import Trainer

    root = str(tmp_path / "graphs")
    ensure_synthetic_dataset(root, name="SYNTH", num_entities=300,
                             num_relations=5, num_classes=3, avg_degree=4.0,
                             seed=3)
    ds = os.path.join(root, "SYNTH")
    data = Dataset(os.path.join(ds, "SYNTH_complete.nt"),
                   os.path.join(ds, "attr", "sum"),
                   os.path.join(ds, "attr", "map")).init_dataset()
    configs = {"dataset": "SYNTH", "e_trans": False, "w_trans": False,
               "num_sums": 1}
    kw = dict(hidden_l=8, epochs=6, emb_dim=8, lr=0.01, weight_d=5e-5,
              seed=0, backend="gather")
    res1 = Trainer(data, **kw).train_original(
        "summation", configs, "baseline", verbose=False)
    res8 = Trainer(data, **kw, devices=8, partition="halo",
                   reorder=True).train_original(
        "summation", configs, "baseline", verbose=False)
    np.testing.assert_allclose(res1["loss"], res8["loss"], rtol=2e-3,
                               atol=2e-4)
    assert abs(res1["test_acc"] - res8["test_acc"]) <= 0.25
