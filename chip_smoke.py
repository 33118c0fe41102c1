"""GPU smoke test of the R-GCN training path, through the entry points a
user calls.

    python chip_smoke.py            # one GPU: phases 0-3
    python chip_smoke.py --chips 4  # four GPUs: the multi-device path only

Phases (one process, one GPU):

0. device: JAX's first device must be a GPU; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
1. parity: ``rgcn_conv``'s forward and its gradients with respect to x, W,
   root and bias, in both dataflows and in float32 and bfloat16, against
   :func:`reference_conv_and_grads`, a per-relation float32 segment-sum
   written without ``ops/`` and run at ``highest`` matmul precision. Shapes:
   the bench graph (N=200k, E=4M, 91 slots) at 64->16 and 16->8, and the
   AM width 63->16 with 267 slots.
2. the whole job: ``main.main`` on an AIFB-shaped synthetic graph (8,285
   entities, 45 relations, 4 classes, ~29k triples), attention head, emb
   63, hidden 16, 51 epochs: summary pre-training, transfer, fine-tuning,
   evaluation and the results JSON.
3. AM-shaped steps: 1.67M entities, 267 relation slots, 12M edges, emb 63,
   hidden 16, 11 classes through the Trainer's jitted fit, with the
   compiled step's ``memory_analysis()``; the loss must be finite and fall.

``--chips 4`` runs a 2-layer train step on four GPUs with the edge and the
halo partition, compares loss and gradients with the one-GPU run of the
same graph in the same (edge) dataflow, all at default matmul precision,
and trains a few epochs through the CLI with ``-devices 4`` (the default
halo partition).

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; it is printed
only when every phase passed. Without a GPU, or without the repository
beside this file, the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import atexit
import glob
import json
import math
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Parity tolerances on max|got - ref| / max|ref| (per compared array), each
# set between the largest error of a sound run and that of a known fault
# (readings on an H100: PERF.md):
# - float32: the program's matmuls run at default precision, which XLA
#   executes in TF32 (10-bit mantissa): 2.1e-4 to 3.8e-4 measured. A float32
#   path that ran in bfloat16 reads 2.2e-3 or more, above the bound;
# - bfloat16: inputs, messages and their cotangents are rounded to 8-bit
#   mantissas while every sum accumulates in float32: 2.2e-3 to 3.7e-3
#   measured. Sums of a node's in-edges in bfloat16 read 1.1e-2 to 1.7e-2;
# - both: segment sums use float atomics, whose order changes from run to
#   run (about 1e-7 relative in float32, far below either bound).
TOLERANCE = {"float32": 1.5e-3, "bfloat16": 7e-3}
# Multi-device parity against the one-GPU edge dataflow, all at default
# precision: XLA picks TF32 or float32 per matmul from its shape, so the
# partitions' smaller matmuls and the one-GPU ones may round different
# products (1.9e-4 measured), besides summing in another order. The
# float32 bound above: a path that lost precision reads 2.2e-3 or more.
MULTI_DEVICE_TOLERANCE = TOLERANCE["float32"]
# Phase 2: test accuracy must beat chance (1/classes) by this many points.
ACCURACY_MARGIN = 0.10

# Shapes. Phase 1: (name, nodes, edges, relation slots, d_in, d_out).
PARITY_CASES = [("bench", 200_000, 4_000_000, 91, 64, 16),
                ("bench", 200_000, 4_000_000, 91, 16, 8),
                ("am-width", 200_000, 4_000_000, 267, 63, 16)]
# Phase 2: AIFB's shape (8,285 entities, 45 relations, 4 classes, 29,043
# triples) and the reference's published run settings.
JOB_CLASSES = 4
JOB_GRAPH = ["-synth_entities", "8285", "-synth_relations", "45",
             "-synth_classes", str(JOB_CLASSES), "-synth_degree", "3.5"]
JOB_RUN = ["-sum", "attr", "-emb", "63", "-hl", "16", "-i", "1"]
JOB_EPOCHS = 51
# Phase 3: AM (1.67M entities, 133 relations -> 267 slots, ~6M triples
# doubled to 12M edges, 11 classes) at emb 63, hidden 16.
AM_SHAPE = dict(nodes=1_670_000, edges=12_000_000, slots=267, emb=63,
                hidden=16, classes=11, labeled=6000, epochs=6)
# --chips 4: the bench graph, 2 layers 64 -> 16 -> 8.
MULTI_SHAPE = dict(nodes=200_000, edges=4_000_000, slots=91, emb=64,
                   hidden=16, classes=8)


def log(*args) -> None:
    print(*args, flush=True)


def final_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref| in float64 on the host."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max())
    return float(np.abs(got - ref).max()) / (scale if scale > 0 else 1.0)


def seeded_edges(num_nodes: int, num_edges: int, num_slots: int, seed: int):
    """Uniform random (src, dst, relation) over the first num_slots - 1
    slots; the last slot stays empty, as ``Graph.num_relation_slots``
    keeps it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    dst = rng.integers(0, num_nodes, num_edges, dtype=np.int32)
    rel = rng.integers(0, num_slots - 1, num_edges, dtype=np.int32)
    return src, dst, rel


def reference_conv_and_grads(x, w, root, bias, src, dst, rel, g):
    """R-GCN layer and the gradients of ``sum(out * g)``, one relation at a
    time, in float32 at the highest matmul precision.

    out = x @ root + bias + sum_r mean_{(j -> i) in r} x_j @ w[r]

    Returns (out, dx, dw, droot, dbias). Written from the formula alone:
    no padding, sorting or grouped matmul, and nothing from ``ops/``.
    """
    import jax
    import jax.numpy as jnp

    n = x.shape[0]
    f32 = jnp.float32
    x, w, root, bias, g = (a.astype(f32) for a in (x, w, root, bias, g))

    def body(r, carry):
        out, dx, dw = carry
        member = (rel == r).astype(f32)
        count = jax.ops.segment_sum(member, dst, num_segments=n)
        coef = member * jnp.where(count > 0, 1.0 / jnp.maximum(count, 1.0),
                                  0.0)[dst]
        mean = jax.ops.segment_sum(x[src] * coef[:, None], dst, num_segments=n)
        out = out + mean @ w[r]
        dw = dw.at[r].set(mean.T @ g)
        back = (g @ w[r].T)[dst] * coef[:, None]
        dx = dx + jax.ops.segment_sum(back, src, num_segments=n)
        return out, dx, dw

    with jax.default_matmul_precision("highest"):
        init = (x @ root + bias, g @ root.T, jnp.zeros_like(w))
        out, dx, dw = jax.lax.fori_loop(0, w.shape[0], body, init)
        return out, dx, dw, x.T @ g, g.sum(0)


def hlo_shapes(hlo_text: str):
    """{"dtype[d0,d1,...]": element count} of every array shape in HLO text."""
    import re

    shapes = {}
    for m in re.finditer(r"\b([a-z]+[0-9]*)\[([0-9,]+)\]", hlo_text):
        dims = [int(v) for v in m.group(2).split(",") if v]
        shapes[f"{m.group(1)}[{m.group(2)}]"] = (dims, math.prod(dims))
    return shapes


def per_edge_outer_products(hlo_text: str, e_pad: int, slots: int,
                            d_in: int, d_out: int):
    """Shapes that hold an [E, d_in, d_out] outer product or a per-group
    [G, E, .] expansion (or more elements than either would)."""
    bad = []
    for name, (dims, count) in hlo_shapes(hlo_text).items():
        if count >= e_pad * d_in * d_out or (
                e_pad in dims and slots in dims and len(dims) >= 2):
            bad.append(name)
    return bad


def require_gpu():
    """-> (jax, devices); exits non-zero unless the first device is a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        log(f"FAIL phase 0: no GPU (JAX found {devices[0].platform})")
        sys.exit(2)
    return jax, devices


# -- phase 1 ----------------------------------------------------------------

def phase_parity() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from scaling_rgcn_training_tpu.ops import build_rel_edges, init_rgcn_layer
    from scaling_rgcn_training_tpu.ops.rgcn_conv import rgcn_conv, select_mode

    ref_fn = jax.jit(reference_conv_and_grads)

    def fwd_bwd(params, x, edges, g, mode, cd):
        out, vjp = jax.vjp(
            lambda p, xv: rgcn_conv(xv, edges, p, mode=mode, compute_dtype=cd),
            params, x)
        gp, gx = vjp(g)
        return out, gx, gp

    step = jax.jit(fwd_bwd, static_argnums=(4, 5))
    failures = []
    for k, (name, n, e, slots, d_in, d_out) in enumerate(PARITY_CASES):
        src, dst, rel = seeded_edges(n, e, slots, seed=10 + k)
        edges = build_rel_edges(src, dst, rel, n, slots)
        key = jax.random.key(k)
        params = init_rgcn_layer(key, slots, d_in, d_out)
        params = params._replace(bias=jax.random.normal(
            jax.random.fold_in(key, 1), (d_out,)) * 0.1)
        x = jax.random.normal(jax.random.fold_in(key, 2), (n, d_in))
        g = jax.random.normal(jax.random.fold_in(key, 3), (n, d_out))
        ref = ref_fn(x, params.weight, params.root, params.bias,
                     jnp.asarray(src), jnp.asarray(dst), jnp.asarray(rel), g)
        ref = [np.asarray(a) for a in ref]
        auto = select_mode(n, slots, edges.src.shape[0], d_in, d_out)
        for dtype in ("float32", "bfloat16"):
            cd = None if dtype == "float32" else jnp.bfloat16
            for mode in ("edge", "prematmul"):
                out, gx, gp = step(params, x, edges, g, mode, cd)
                got = [out, gx, gp.weight, gp.root, gp.bias]
                tol = TOLERANCE[dtype]
                errs = {nm: rel_err(a, b) for nm, a, b in zip(
                    ("out", "dx", "dW", "droot", "dbias"), got, ref)}
                ok = all(v <= tol for v in errs.values()) and all(
                    np.isfinite(np.asarray(a)).all() for a in got)
                tag = f"{name} {d_in}->{d_out} slots={slots} {dtype} {mode}" \
                      f"{' (auto)' if mode == auto else ''}"
                log(f"parity {tag}: " + " ".join(
                    f"{nm}={v:.2e}" for nm, v in errs.items())
                    + f" tol={tol:.1e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(tag)
    if failures:
        raise RuntimeError(f"parity failed: {failures}")


# -- phase 2 ----------------------------------------------------------------

def phase_whole_job() -> None:
    import numpy as np

    from scaling_rgcn_training_tpu import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        results = os.path.join(tmp, "results")
        t0 = time.perf_counter()
        cli.main(["-dataset", "SYNTH", *JOB_GRAPH, *JOB_RUN,
                  "-exp", "attention", "-epochs", str(JOB_EPOCHS), "-seed", "0",
                  "-data_root", os.path.join(tmp, "graphs"),
                  "-results_root", results])
        wall = time.perf_counter() - t0
        (report_path,) = glob.glob(os.path.join(results, "*", "report_*.json"))
        (run_path,) = glob.glob(os.path.join(results, "*", "run_results_*.json"))
        with open(report_path) as fh:
            report = json.load(fh)
        with open(run_path) as fh:
            run = json.load(fh)
    losses = np.asarray(run["attention"]["loss"][0], np.float64)
    acc = report["Test acc attention"]["mean"] / 100.0
    floor = 1.0 / JOB_CLASSES + ACCURACY_MARGIN
    log(f"whole job: {wall:.1f} s wall (compilation included), "
        f"{len(losses)} epochs, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"test accuracy {acc:.4f} (must exceed {floor:.2f})")
    if not np.isfinite(losses).all():
        raise RuntimeError("whole job: non-finite loss")
    if not acc > floor:
        raise RuntimeError(f"whole job: test accuracy {acc} <= {floor}")


# -- phase 3 ----------------------------------------------------------------

def phase_am_steps() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from scaling_rgcn_training_tpu.graphs.device import DeviceGraph
    from scaling_rgcn_training_tpu.models import apply_emb_model, init_emb_model
    from scaling_rgcn_training_tpu.ops import build_rel_edges
    from scaling_rgcn_training_tpu.train.losses import ce_loss
    from scaling_rgcn_training_tpu.train.optim import make_optimizer
    from scaling_rgcn_training_tpu.train.trainer import Trainer, _cached_fit_fn

    s = AM_SHAPE
    n, e, slots, emb, hidden, classes, labeled, epochs = (
        s["nodes"], s["edges"], s["slots"], s["emb"], s["hidden"],
        s["classes"], s["labeled"], s["epochs"])
    t0 = time.perf_counter()
    src, dst, rel = seeded_edges(n, e, slots, seed=3)
    edges = build_rel_edges(src, dst, rel, n, slots)
    rng = np.random.default_rng(4)
    nodes = rng.choice(n, labeled, replace=False).astype(np.int32)
    labels = np.eye(classes, dtype=np.float32)[
        rng.integers(0, classes, labeled)]
    n_train = labeled * 5 // 6
    graph = DeviceGraph(edges=edges,
                        x_train=jnp.asarray(nodes[:n_train]),
                        y_train=jnp.asarray(labels[:n_train]),
                        x_val=jnp.asarray(nodes[n_train:]),
                        y_val=jnp.asarray(labels[n_train:]))
    log(f"AM steps: graph built in {time.perf_counter() - t0:.1f} s "
        f"(N={n}, E={e}, slots={slots}, padded E={edges.src.shape[0]})")

    trainer = Trainer(None, hidden_l=hidden, epochs=epochs, emb_dim=emb,
                      lr=0.01, weight_d=5e-5, seed=0)
    params = init_emb_model(jax.random.key(5), slots, hidden, classes, n, emb)
    # the same cache key trainer.fit uses, so fit reuses this program
    run = _cached_fit_fn(apply_emb_model, ce_loss, "softmax", False, epochs,
                         trainer.lr, trainer.weight_d, None, trainer.backend,
                         trainer.compute_dtype, trainer.mesh, trainer.aggr)
    opt_state = make_optimizer(trainer.lr, trainer.weight_d).init(params)
    t0 = time.perf_counter()
    compiled = run.lower(params, opt_state, jax.random.key(0), graph).compile()
    log(f"AM steps: fit compiled in {time.perf_counter() - t0:.1f} s; "
        f"memory_analysis: {compiled.memory_analysis()}")
    hlo = compiled.as_text()
    largest = sorted(hlo_shapes(hlo).items(), key=lambda kv: -kv[1][1])[:4]
    log("AM steps: largest arrays in the optimized HLO: "
        + ", ".join(f"{k} ({v[1]:,} elements)" for k, v in largest))
    bad = per_edge_outer_products(hlo, edges.src.shape[0], slots, emb, hidden)
    if bad:
        raise RuntimeError(f"AM steps: per-edge outer product in HLO: {bad}")
    t0 = time.perf_counter()
    _, _, losses, _, _ = trainer.fit(params, apply_emb_model, graph, ce_loss,
                                     "softmax", sum_graph=False, verbose=False)
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    log(f"AM steps: {epochs} epochs in {wall:.2f} s wall, losses "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    if not np.isfinite(losses).all():
        raise RuntimeError("AM steps: non-finite loss")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"AM steps: loss did not fall: {losses}")


# -- --chips 4 --------------------------------------------------------------

def phase_multi_device(count: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from scaling_rgcn_training_tpu.ops import build_rel_edges, init_rgcn_layer
    from scaling_rgcn_training_tpu.ops.rgcn_conv import rgcn_conv
    from scaling_rgcn_training_tpu.parallel import (
        device_put_halo_edges, device_put_sharded_edges, halo_partition_edges,
        make_mesh, node_sharding, pad_node_array, shard_rel_edges, use_mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P

    if len(jax.devices()) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(jax.devices())}")
    mesh = make_mesh(count)
    ids = {d.id for d in mesh.devices.flat}
    if len(ids) != count:
        raise RuntimeError(f"mesh is not {count} distinct devices: {mesh.devices}")

    s = MULTI_SHAPE
    n, e, slots, d, hidden, classes = (s["nodes"], s["edges"], s["slots"],
                                       s["emb"], s["hidden"], s["classes"])
    src, dst, rel = seeded_edges(n, e, slots, seed=21)
    key = jax.random.key(21)
    emb = jax.random.normal(key, (n, d))
    l1 = init_rgcn_layer(jax.random.fold_in(key, 1), slots, d, hidden)
    l2 = init_rgcn_layer(jax.random.fold_in(key, 2), slots, hidden, classes)
    g = jax.random.normal(jax.random.fold_in(key, 3), (n, classes))

    def loss_of(params, edges, gv, mode, act):
        x, a, b = params
        z = act(rgcn_conv(x, edges, a, mode=mode))
        out = rgcn_conv(z, edges, b, mode=mode)
        return jnp.vdot(out[:gv.shape[0]], gv)

    def compare(v, grads, v_ref, g_ref):
        errs = {"loss": rel_err(v, v_ref),
                "demb": rel_err(grads[0][:n], g_ref[0])}
        for layer, (ga, gb) in enumerate(zip(grads[1:], g_ref[1:]), start=1):
            for field in ("weight", "root", "bias"):
                errs[f"d{field}{layer}"] = rel_err(getattr(ga, field),
                                                   getattr(gb, field))
        return errs

    def show(errs):
        return " ".join(f"{k}={v_:.2e}" for k, v_ in errs.items())

    # At default precision XLA rounds a matmul's products to TF32 or not by
    # its shape, so one GPU and the partitions round different products. A
    # ReLU gradient jumps where a pre-activation crosses zero, and a couple
    # of such crossings move demb by percents: shown below on one GPU
    # (select_mode's dataflows vs the edge dataflow), not checked. The
    # partitions are checked with tanh in the ReLU's place, which has no
    # jump, against one GPU in their own (edge) dataflow.
    value_and_grad = jax.jit(jax.value_and_grad(loss_of),
                             static_argnums=(3, 4))
    single = build_rel_edges(src, dst, rel, n, slots)
    base = (emb, l1, l2)
    runs = {(mode, act.__name__): jax.tree.map(
                np.asarray, value_and_grad(base, single, g, mode, act))
            for mode in ("edge", "auto") for act in (jax.nn.relu, jnp.tanh)}
    layer1 = jax.jit(lambda x, e, p, mode: rgcn_conv(x, e, p, mode=mode),
                     static_argnums=3)
    flips = int(jnp.sum((layer1(emb, single, l1, "auto") > 0)
                        != (layer1(emb, single, l1, "edge") > 0)))
    for act in ("relu", "tanh"):
        log(f"1 GPU, {act}, select_mode's dataflows vs the edge dataflow: "
            f"{show(compare(*runs['auto', act], *runs['edge', act]))}"
            + (f"; layer-1 ReLU sign flips {flips} of {n * hidden}"
               if act == "relu" else ""))
    v1, g1 = runs["edge", "tanh"]

    rep = NamedSharding(mesh, P())
    for partition in ("edge", "halo"):
        if partition == "edge":
            edges = device_put_sharded_edges(
                shard_rel_edges(src, dst, rel, n, slots, count), mesh)
            x = jax.device_put(emb, rep)
            arrays = [edges.src]
        else:
            edges = device_put_halo_edges(
                halo_partition_edges(src, dst, rel, n, slots, count), mesh)
            x = jax.device_put(pad_node_array(emb, edges), node_sharding(mesh))
            arrays = [edges.lsrc, x]
        for a in arrays:
            where = sorted(sh.device.id for sh in a.addressable_shards)
            if where != sorted(ids):
                raise RuntimeError(f"{partition}: shards on devices {where}")
        params = (x, jax.device_put(l1, rep), jax.device_put(l2, rep))
        t0 = time.perf_counter()
        with use_mesh(mesh):
            v, grads = value_and_grad(params, edges, jax.device_put(g, rep),
                                      "edge", jnp.tanh)
            jax.block_until_ready(grads)
        wall = time.perf_counter() - t0
        grads = jax.tree.map(np.asarray, grads)
        errs = compare(v, grads, v1, g1)
        ok = all(v_ <= MULTI_DEVICE_TOLERANCE for v_ in errs.values())
        log(f"{count}-GPU {partition} partition vs 1 GPU edge dataflow, tanh "
            f"(first call {wall:.1f} s): {show(errs)} "
            f"tol={MULTI_DEVICE_TOLERANCE:.1e} {'ok' if ok else 'FAIL'}")
        log(f"{count}-GPU {partition} partition vs 1 GPU select_mode "
            f"dataflows, tanh (shown, not checked): "
            f"{show(compare(v, grads, *runs['auto', 'tanh']))}")
        if not ok:
            raise RuntimeError(f"{partition} partition disagrees with 1 GPU")

    from scaling_rgcn_training_tpu import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        results = os.path.join(tmp, "results")
        cli.main(["-dataset", "SYNTH", *JOB_GRAPH, *JOB_RUN,
                  "-exp", "summation", "-epochs", "5",
                  "-devices", str(count), "-partition", "halo",
                  "-data_root", os.path.join(tmp, "graphs"),
                  "-results_root", results])
        (run_path,) = glob.glob(os.path.join(results, "*", "run_results_*.json"))
        with open(run_path) as fh:
            losses = json.load(fh)["summation"]["loss"][0]
    log(f"CLI -devices {count} -partition halo: losses "
        + " ".join(f"{v:.4f}" for v in losses))
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError("CLI -devices: non-finite loss")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4),
                        help="4: run only the four-GPU path")
    args = parser.parse_args(argv)

    jax, devices = require_gpu()
    sys.path.insert(0, REPO)
    try:
        from scaling_rgcn_training_tpu.utils import jaxcache
        from scaling_rgcn_training_tpu.utils.gpu import card_description
    except ImportError as exc:
        log(f"FAIL: the repository is not beside this script ({exc})")
        return 3
    jaxcache.enable()
    log(f"card: {card_description()}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")

    phases = ([("multi-device", lambda: phase_multi_device(args.chips))]
              if args.chips > 1 else
              [("parity", phase_parity), ("whole job", phase_whole_job),
               ("AM steps", phase_am_steps)])
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - report and fail the run
            import traceback

            traceback.print_exc()
            log(f"FAIL phase {name}: {type(exc).__name__}: {exc}")
            return 1
        log(f"== phase {name} passed in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card_description()}")
    # main.main registers an end-of-program banner; the JSON line is last
    from scaling_rgcn_training_tpu.utils import timing

    atexit.unregister(timing.endlog)
    print(final_line(devices[0].platform, devices[0].device_kind,
                     len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
