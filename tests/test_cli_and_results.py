"""CLI driver, config checks, results schema, synthetic generator."""

import json
import os

import numpy as np
import pytest

from scaling_rgcn_training_tpu.utils.checks import do_checks, check_emb_dim
from scaling_rgcn_training_tpu.utils.results import Results
from scaling_rgcn_training_tpu.graphs.synthetic import generate_synthetic_nt, ensure_synthetic_dataset


def test_check_emb_dim_rounds_to_multiple():
    cfg = {"emb": 63}
    check_emb_dim(cfg, 3)
    assert cfg["emb"] == 63  # 63 = 21*3 already a multiple
    cfg = {"emb": 64}
    check_emb_dim(cfg, 3)
    assert cfg["emb"] == 63  # round(64/3)*3 = 63


def test_check_e_trans_num_sums(tmp_path):
    ds_dir = ensure_synthetic_dataset(str(tmp_path), num_entities=200,
                                      num_relations=6, num_classes=3, seed=3)
    sum_dir = os.path.join(ds_dir, "attr", "sum")
    map_dir = os.path.join(ds_dir, "attr", "map")
    cfg, _ = do_checks({"emb": 63, "e_trans": False}, sum_dir, map_dir)
    assert cfg["num_sums"] == 1
    cfg, files = do_checks({"emb": 63, "e_trans": True}, sum_dir, map_dir)
    assert cfg["num_sums"] == 3
    assert len(files) == 3


def test_results_schema(tmp_path):
    r = Results()
    r.add_key("summation")
    for it in range(2):
        r.update_run_results({"accuracy": [0.1 * it, 0.2, 0.5 + 0.1 * it],
                              "loss": [1.0, 0.5, 0.2]}, "summation")
        r.add_test_results("summation", 0.7 + 0.1 * it, 0.6, 0.5)
    cfg = {"dataset": "TEST", "exp": "summation", "sum": "attr", "i": 2, "epochs": 3}
    out = r.process_results(cfg, results_root=str(tmp_path), plots=False)
    report = json.load(open(os.path.join(out, "report_summation_attr_i=2.json")))
    run = json.load(open(os.path.join(out, "run_results_summation_attr_i=2.json")))
    # run_results: [mean, mean-std, mean+std]
    assert len(run["summation"]["accuracy"]) == 3
    np.testing.assert_allclose(run["summation"]["accuracy"][0], [0.05, 0.2, 0.55])
    # report: max/epoch uses the reference's epoch-1 convention
    assert report["summation"]["accuracy"] == {"epoch": 1, "max": 55.0}
    assert report["Test acc summation"] == {"mean": 75.0, "std": 5.0}


def test_synthetic_generator(tmp_path):
    p = generate_synthetic_nt(str(tmp_path / "S_complete.nt"), num_entities=300,
                              num_relations=8, num_classes=3, avg_degree=5,
                              seed=11)
    lines = open(p).read().splitlines()
    assert all(l.endswith(" .") for l in lines)
    type_lines = [l for l in lines if "rdf-syntax-ns#type" in l]
    assert len(type_lines) > 0
    # deterministic under seed
    p2 = generate_synthetic_nt(str(tmp_path / "S2_complete.nt"), num_entities=300,
                               num_relations=8, num_classes=3, avg_degree=5,
                               seed=11)
    assert open(p).read() == open(p2).read()


def test_ensure_synthetic_dataset_layout(tmp_path):
    ds_dir = ensure_synthetic_dataset(str(tmp_path), num_entities=200,
                                      num_relations=6, num_classes=3)
    assert os.path.exists(os.path.join(ds_dir, "SYNTH_complete.nt"))
    sums = os.listdir(os.path.join(ds_dir, "attr", "sum"))
    maps = os.listdir(os.path.join(ds_dir, "attr", "map"))
    assert len(sums) == 3 and len(maps) == 3


def test_cli_end_to_end(ref_graphs_dir, tmp_path, monkeypatch):
    from scaling_rgcn_training_tpu import main as cli

    monkeypatch.chdir(tmp_path)
    cli.main(["-dataset", "TEST", "-sum", "attr", "-exp", "summation",
              "-i", "1", "-epochs", "3", "-emb", "6", "-hl", "4",
              "-results_root", str(tmp_path / "results")])
    out_dirs = os.listdir(tmp_path / "results")
    assert len(out_dirs) == 1
    files = os.listdir(tmp_path / "results" / out_dirs[0])
    assert any(f.startswith("report_") for f in files)
    assert any(f.startswith("run_results_") for f in files)


def test_plot_filenames_reference_parity(tmp_path):
    """One PDF per (exp, metric), named {ds}_{exp}_{metric}_{sum}_i={i}.pdf
    (reference helpers/results.py:115)."""
    pytest.importorskip("matplotlib")
    r = Results()
    for exp in ("baseline", "summation"):
        r.add_key(exp)
        r.update_run_results({"accuracy": [0.1, 0.2, 0.3],
                              "loss": [1.0, 0.5, 0.2]}, exp)
    cfg = {"dataset": "TEST", "exp": "summation", "sum": "attr", "i": 1,
           "epochs": 3}
    out = r.process_results(cfg, results_root=str(tmp_path), plots=True)
    for exp in ("baseline", "summation"):
        for metric in ("accuracy", "loss"):
            f = os.path.join(out, f"TEST_{exp}_{metric}_attr_i=1.pdf")
            assert os.path.exists(f), sorted(os.listdir(out))
