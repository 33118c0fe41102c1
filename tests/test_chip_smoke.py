"""chip_smoke.py's own logic on the CPU: its float32 reference, its phases
at tiny sizes, its last line, and that it refuses to run without a GPU.

The script itself needs a GPU; here its phase functions are called
directly with shrunken shapes.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _dense_loss(params, x, src, dst, rel, g):
    w, root, bias = params
    n = x.shape[0]
    out = x @ root + bias
    for r in range(w.shape[0]):
        m = jnp.asarray(rel == r, jnp.float32)
        cnt = jax.ops.segment_sum(m, dst, num_segments=n)
        s = jax.ops.segment_sum(x[src] * m[:, None], dst, num_segments=n)
        out = out + (s / jnp.maximum(cnt, 1.0)[:, None]) @ w[r]
    return jnp.vdot(out, g), out


@pytest.mark.parametrize("d_in,d_out", [(8, 4), (63, 16)])
def test_reference_matches_autodiff_of_dense_conv(d_in, d_out):
    n, e, slots = 30, 200, 7
    src, dst, rel = chip_smoke.seeded_edges(n, e, slots, seed=d_in)
    k = jax.random.key(d_in)
    x = jax.random.normal(k, (n, d_in))
    w = jax.random.normal(jax.random.fold_in(k, 1), (slots, d_in, d_out))
    root = jax.random.normal(jax.random.fold_in(k, 2), (d_in, d_out))
    bias = jax.random.normal(jax.random.fold_in(k, 3), (d_out,))
    g = jax.random.normal(jax.random.fold_in(k, 4), (n, d_out))
    out, dx, dw, droot, dbias = chip_smoke.reference_conv_and_grads(
        x, w, root, bias, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(rel), g)
    (_, want), grads = jax.value_and_grad(_dense_loss, argnums=(0, 1),
                                          has_aux=True)(
        (w, root, bias), x, src, dst, rel, g)
    (gw, groot, gbias), gx = grads
    for got, ref in ((out, want), (dx, gx), (dw, gw), (droot, groot),
                     (dbias, gbias)):
        assert chip_smoke.rel_err(got, ref) < 1e-5


def test_seeded_edges_keep_last_slot_empty():
    src, dst, rel = chip_smoke.seeded_edges(50, 4000, 9, seed=0)
    assert rel.max() == 7 and src.max() < 50 and dst.max() < 50
    again = chip_smoke.seeded_edges(50, 4000, 9, seed=0)
    assert all((a == b).all() for a, b in zip((src, dst, rel), again))


def test_rel_err_is_max_abs_over_max_abs():
    assert chip_smoke.rel_err([1.0, -4.0], [1.0, -2.0]) == pytest.approx(1.0)
    assert chip_smoke.rel_err([0.0], [0.0]) == 0.0


def test_final_line_format():
    line = chip_smoke.final_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_parity_phase_at_tiny_shapes(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "PARITY_CASES",
                        [("tiny", 60, 500, 9, 16, 8), ("tiny", 50, 400, 11, 63, 16)])
    chip_smoke.phase_parity()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("parity")]
    assert len(lines) == 8 and all(ln.endswith(" ok") for ln in lines)
    assert sum("(auto)" in ln for ln in lines) == 4


def test_whole_job_and_am_phases_at_tiny_shapes(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "JOB_GRAPH", [
        "-synth_entities", "400", "-synth_relations", "5",
        "-synth_classes", "4", "-synth_degree", "3.5"])
    monkeypatch.setattr(chip_smoke, "JOB_EPOCHS", 20)
    monkeypatch.setattr(chip_smoke, "ACCURACY_MARGIN", -1.0)
    chip_smoke.phase_whole_job()
    monkeypatch.setattr(chip_smoke, "AM_SHAPE", dict(
        nodes=2000, edges=20000, slots=21, emb=63, hidden=16, classes=11,
        labeled=600, epochs=4))
    chip_smoke.phase_am_steps()
    out = capsys.readouterr().out
    assert "whole job:" in out and "memory_analysis" in out


def test_multi_device_phase_on_four_virtual_devices(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "MULTI_SHAPE", dict(
        nodes=300, edges=3000, slots=9, emb=16, hidden=8, classes=4))
    monkeypatch.setattr(chip_smoke, "JOB_GRAPH", [
        "-synth_entities", "300", "-synth_relations", "4",
        "-synth_classes", "3", "-synth_degree", "3.5"])
    chip_smoke.phase_multi_device(4)
    out = capsys.readouterr().out
    checked = [ln for ln in out.splitlines() if "dataflow, tanh (first" in ln]
    assert len(checked) == 2 and all(ln.endswith(" ok") for ln in checked)
    assert "ReLU sign flips" in out and "CLI -devices 4" in out


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    res = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_outer_product_detector():
    hlo = ("%a = f32[5000,63,16]{2,1,0} fusion(...)\n"
           "%b = bf16[11,5000,16]{2,1,0} fusion(...)\n"
           "%c = f32[5000,63]{1,0} gather(...)\n"
           "%d = f32[40,128,63]{2,1,0} dot(...)\n")
    bad = chip_smoke.per_edge_outer_products(hlo, 5000, 11, 63, 16)
    assert sorted(bad) == ["bf16[11,5000,16]", "f32[5000,63,16]"]
    assert chip_smoke.hlo_shapes(hlo)["f32[5000,63]"] == ([5000, 63], 315000)
