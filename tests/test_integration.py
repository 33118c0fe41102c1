"""End-to-end quality integration: the full experiment matrix on synthetic
data must learn (beat chance clearly) and the transfer pipeline must run
through every head — the framework-level analogue of the reference's
AIFB-accuracy check (its original datasets are missing LFS blobs).

The fixture carries a 104-node test split (r5; the old 21-node split made
1 node = 4.8 points and forced ±12.5-point bands — now 1 node < 1 point
and every band is pinned at a few node-flips around recorded values,
matching the rigor of the reference's frozen baseline band,
reference helpers/results.py:77-98)."""

import numpy as np
import pytest

from scaling_rgcn_training_tpu.graphs.synthetic import ensure_synthetic_dataset
from scaling_rgcn_training_tpu.graphs.dataset import Dataset
from scaling_rgcn_training_tpu.train.trainer import Trainer


@pytest.fixture(scope="module")
def synth_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthds")
    ds_dir = ensure_synthetic_dataset(
        str(root), num_entities=3000, num_relations=8, num_classes=3,
        avg_degree=6, seed=42, labeled_fraction=0.18)
    data = Dataset(
        f"{ds_dir}/SYNTH_complete.nt", f"{ds_dir}/attr/sum", f"{ds_dir}/attr/map",
    ).init_dataset(verbose=False)
    assert len(np.asarray(data.orgGraph.x_test)) >= 100
    return data


@pytest.mark.slow
def test_baseline_learns(synth_data):
    t = Trainer(synth_data, hidden_l=16, epochs=40, emb_dim=24, lr=0.01,
                weight_d=5e-5, seed=0, backend="gather")
    res = t.train_original(
        "summation", {"dataset": "SYNTH", "num_sums": 1, "e_trans": False,
                      "w_trans": False}, "baseline", verbose=False)
    # pinned band around the recorded seed-0 value (0.827 on the 104-node
    # split; ±0.03 = ±3 node flips)
    assert 0.797 <= res["test_acc"] <= 0.857, res["test_acc"]
    assert max(res["accuracy"]) > 0.75


@pytest.mark.slow
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
def test_transfer_matrix_beats_baseline(synth_data, compute_dtype):
    """The reference's core scientific claim (README.md:5-14): summary
    pre-training + transfer outperforms the from-scratch baseline, with
    the head ordering attention >= mlp >= summation > baseline — and it
    must hold in the bench-default mixed-precision regime too (bf16 edge
    streams / f32 accumulation, the bench.py default), not just f32.

    Recorded at 30 epochs on the 104-node split (3 seeds each):
      f32  baseline .827/.788/.808  summation .923/.913/.923
           mlp .971/.904/.933       attention .962/.942/.923
           means: baseline 0.808, summation 0.920, mlp 0.936, att 0.942
      bf16 means: baseline 0.804, summation 0.917, mlp 0.936, att 0.933
    Means are pinned at ±0.03 (≈3 node flips at mean level); per-seed
    values at ±0.05."""
    cfg_b = {"dataset": "SYNTH", "num_sums": 1, "e_trans": False,
             "w_trans": False}
    configs = {"dataset": "SYNTH", "num_sums": 3, "e_trans": True,
               "e_freeze": True, "w_trans": True, "w_grad": True}
    recorded_means = (
        {"baseline": 0.808, "summation": 0.920, "mlp": 0.936,
         "attention": 0.942}
        if compute_dtype is None else
        {"baseline": 0.804, "summation": 0.917, "mlp": 0.936,
         "attention": 0.933})
    accs = {e: [] for e in ["baseline", "summation", "mlp", "attention"]}
    for seed in range(3):
        t0 = Trainer(synth_data, hidden_l=16, epochs=30, emb_dim=24,
                     lr=0.01, weight_d=5e-5, seed=seed * 10,
                     backend="gather", compute_dtype=compute_dtype)
        accs["baseline"].append(t0.train_original(
            "summation", cfg_b, "baseline", verbose=False)["test_acc"])
        t = Trainer(synth_data, hidden_l=16, epochs=30, emb_dim=24,
                    lr=0.01, weight_d=5e-5, seed=seed * 10 + 1,
                    backend="gather", compute_dtype=compute_dtype)
        t.train_summaries(configs, verbose=False)
        for exp in ["summation", "mlp", "attention"]:
            res = t.train_original(exp, configs, exp, verbose=False)
            accs[exp].append(res["test_acc"])
            assert np.isfinite(res["loss"]).all()
            assert res["loss"][-1] < res["loss"][0]  # training progresses
    mean = {e: float(np.mean(v)) for e, v in accs.items()}
    # pinned mean bands (±0.03 of the recorded values)
    for exp, want in recorded_means.items():
        assert abs(mean[exp] - want) <= 0.03, (exp, mean[exp], want)
    # per-seed values stay within ±0.05 of their mean (no degenerate seed)
    for exp, vals in accs.items():
        for v in vals:
            assert abs(v - mean[exp]) <= 0.05, (exp, vals)
    # head ordering (reference README.md:5-14 claim), mean-level tolerance
    assert mean["attention"] >= mean["mlp"] - 0.03, mean
    assert mean["mlp"] >= mean["summation"] - 0.03, mean
    # every transfer head clearly beats the from-scratch baseline
    for exp in ["summation", "mlp", "attention"]:
        assert mean[exp] >= mean["baseline"] + 0.05, (exp, mean)
    assert mean["attention"] >= mean["baseline"] + 0.08, mean


@pytest.mark.slow
def test_frozen_transfer_variants(synth_data):
    """e_freeze / w_grad=False paths: frozen leaves really stay frozen."""
    import jax

    configs = {"dataset": "SYNTH", "num_sums": 3, "e_trans": True,
               "e_freeze": True, "w_trans": True, "w_grad": False}
    t = Trainer(synth_data, hidden_l=16, epochs=5, emb_dim=24, lr=0.01,
                weight_d=5e-5, seed=2, backend="gather")
    t.train_summaries(configs, verbose=False)
    res = t.train_original("summation", configs, "summation", verbose=False)
    params = res["params"]
    # conv weights must equal the transferred (frozen) summary weights
    np.testing.assert_array_equal(
        np.asarray(params.rgcn1.weight), np.asarray(t.sum_params.rgcn1.weight))
    np.testing.assert_array_equal(
        np.asarray(params.rgcn2.root), np.asarray(t.sum_params.rgcn2.root))
