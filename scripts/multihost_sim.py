"""Multi-host (DCN) simulation: 2 processes x 4 virtual CPU devices.

The reference has no distributed backend at all (SURVEY.md §2: no
torch.distributed anywhere; one ``.to(device)``, modelTrainer.py:16). This
framework's multi-host story is ``jax.distributed.initialize`` + a global
mesh; this script proves the WHOLE path end to end on one CPU host:

- parent: runs the 8-device single-process halo train loop (the oracle),
  then spawns 2 child processes that each own 4 virtual CPU devices and
  join a 2-process JAX cluster over localhost (the DCN stand-in);
- children: ``initialize_multihost`` -> global 8-device mesh ->
  halo-partitioned edges ingested via ``make_array_from_callback`` ->
  the identical jitted train scan, with the all_to_all now crossing the
  process boundary;
- parity: the multi-process loss trajectory must match the
  single-process one to float32 tolerance.

Writes MULTIHOST JSON to stdout (one line) in parent mode.
Usage: python scripts/multihost_sim.py            # parent
       python scripts/multihost_sim.py --child I  # internal
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N = int(os.environ.get("MH_NODES", 2048))
E = int(os.environ.get("MH_EDGES", 16384))
R = int(os.environ.get("MH_RELS", 5))
D, HL, C = 16, 8, 4
STEPS = int(os.environ.get("MH_STEPS", 5))
PORT = int(os.environ.get("MH_PORT", 47621))
NPROC = 2
DEV_PER_PROC = 4


def train_losses():
    """Build graph + params deterministically and run STEPS halo steps.

    Runs identically in single-process (8 local devices) and multi-process
    (2 x 4 devices) mode: everything derives from fixed seeds and
    ``make_mesh`` over the GLOBAL device list.
    """
    import numpy as np
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from scaling_rgcn_training_tpu.ops import init_rgcn_layer
    from scaling_rgcn_training_tpu.parallel import (
        make_mesh, halo_partition_edges, device_put_halo_edges,
        halo_rgcn_conv, padded_num_nodes, node_sharding)
    from scaling_rgcn_training_tpu.parallel.mesh import put_global
    from scaling_rgcn_training_tpu.train.losses import bce_loss

    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    typ = rng.integers(0, 2 * R, E).astype(np.int32)
    slots = 2 * R + 1

    # r5 defaults: locality reorder before partitioning (deterministic,
    # identical in the single- and multi-process arm)
    if os.environ.get("MH_REORDER", "1") != "0":
        from scaling_rgcn_training_tpu.parallel import locality_reorder

        perm = locality_reorder(src, dst, N, num_shards=NPROC * DEV_PER_PROC)
        src, dst = perm[src], perm[dst]

    mesh = make_mesh(NPROC * DEV_PER_PROC)
    hedges = device_put_halo_edges(
        halo_partition_edges(src, dst, typ, N, slots, NPROC * DEV_PER_PROC,
                             pad_to_multiple=64, halo_multiple=8), mesh)
    n_pad = padded_num_nodes(hedges)
    emb_host = np.asarray(jax.random.normal(jax.random.key(0), (n_pad, D)))
    emb = put_global(emb_host, node_sharding(mesh))
    rep = NamedSharding(mesh, P())
    l1 = jax.tree.map(lambda a: put_global(np.asarray(a), rep),
                      init_rgcn_layer(jax.random.key(1), slots, D, HL))
    l2 = jax.tree.map(lambda a: put_global(np.asarray(a), rep),
                      init_rgcn_layer(jax.random.key(2), slots, HL, C))
    y = put_global(np.asarray(jax.nn.one_hot(np.arange(128) % C, C)), rep)
    idx = put_global(np.arange(128, dtype=np.int32), rep)

    opt = optax.adam(0.05)
    params = (emb, l1, l2)
    state = opt.init(params)

    # bf16 halo/edge streams (the bench default), f32 reductions
    cd = jnp.bfloat16 if os.environ.get("MH_BF16", "1") != "0" else None

    def loss_of(p, hd, yv, iv):
        e_, a_, b_ = p
        z = jax.nn.relu(halo_rgcn_conv(e_, hd, a_, mesh, compute_dtype=cd))
        logits = halo_rgcn_conv(z, hd, b_, mesh, compute_dtype=cd)
        return bce_loss(logits[iv], yv)

    # multi-controller rule: global arrays must be jit ARGUMENTS (closing
    # over non-addressable shards is an error)
    @jax.jit
    def step(p, st, hd, yv, iv):
        loss, grads = jax.value_and_grad(loss_of)(p, hd, yv, iv)
        updates, st2 = opt.update(grads, st)
        return optax.apply_updates(p, updates), st2, loss

    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, hedges, y, idx)
        losses.append(float(loss))
    return losses


def run_child(proc_id: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from scaling_rgcn_training_tpu.parallel.mesh import initialize_multihost

    initialize_multihost(coordinator_address=f"localhost:{PORT}",
                         num_processes=NPROC, process_id=proc_id)
    assert jax.process_count() == NPROC
    assert len(jax.devices()) == NPROC * DEV_PER_PROC, (
        f"global devices: {len(jax.devices())}")
    losses = train_losses()
    if proc_id == 0:
        print("CHILD_LOSSES " + json.dumps(losses), flush=True)


def run_parent() -> None:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", "").strip()
        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}").strip()

    # oracle: same training in ONE process with 8 virtual devices
    one_env = dict(env)
    one_env["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", "").strip()
        + f" --xla_force_host_platform_device_count={NPROC * DEV_PER_PROC}"
    ).strip()
    single = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--single"],
        env=one_env, capture_output=True, text=True, timeout=600)
    assert single.returncode == 0, single.stderr[-3000:]
    ref = json.loads([ln for ln in single.stdout.splitlines()
                      if ln.startswith("CHILD_LOSSES")][0].split(" ", 1)[1])

    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(NPROC)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"child failed:\n{se[-3000:]}"
    multi = json.loads([ln for ln in outs[0][0].splitlines()
                        if ln.startswith("CHILD_LOSSES")][0].split(" ", 1)[1])

    import numpy as np

    ok = bool(np.allclose(ref, multi, rtol=1e-5, atol=1e-6))
    print(json.dumps({
        "processes": NPROC, "devices_per_process": DEV_PER_PROC,
        "global_devices": NPROC * DEV_PER_PROC, "steps": STEPS,
        "single_process_losses": ref, "multi_process_losses": multi,
        "loss_parity": ok, "hardware": "cpu (DCN simulated over localhost)",
        "features": {
            "compute_dtype": ("bfloat16"
                              if os.environ.get("MH_BF16", "1") != "0"
                              else "float32"),
            "locality_reorder": os.environ.get("MH_REORDER", "1") != "0",
        },
    }))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    if "--child" in sys.argv:
        run_child(int(sys.argv[sys.argv.index("--child") + 1]))
    elif "--single" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        losses = train_losses()
        print("CHILD_LOSSES " + json.dumps(losses), flush=True)
    else:
        run_parent()
