"""Scaling-efficiency benchmark: edges/s vs device count (halo SPMD path).

North-star methodology (BASELINE.md): per-device edge throughput of the
fwd+bwd train step should scale to >=80% efficiency as devices grow. On a
multi-GPU host this measures the real halo exchange (NCCL over NVLink); on
a single-host CPU run it exercises the identical program over virtual
devices (JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8),
which validates the collective structure but NOT hardware scaling — the
report labels which one it measured.

Prints one JSON line per device count:
    {"devices": k, "ms_per_step": t, "edges_per_s": v, "efficiency": r}
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scaling_rgcn_training_tpu.utils import jaxcache

jaxcache.enable()

import jax
import jax.numpy as jnp
import optax

from scaling_rgcn_training_tpu.ops import init_rgcn_layer
from scaling_rgcn_training_tpu.parallel import (
    make_mesh, halo_partition_edges, device_put_halo_edges, halo_rgcn_conv,
    padded_num_nodes, node_sharding)
from scaling_rgcn_training_tpu.train.losses import bce_loss

n = int(os.environ.get("BENCH_NODES", 100_000))
e = int(os.environ.get("BENCH_EDGES", 2_000_000))
r = int(os.environ.get("BENCH_RELS", 20))
d = int(os.environ.get("BENCH_DIM", 64))
hl = int(os.environ.get("BENCH_HIDDEN", 16))
c = 8
inner = int(os.environ.get("BENCH_INNER", 5))
calls = int(os.environ.get("BENCH_CALLS", 3))
# Graph structure: "sbm" (default) is the representative case — real RDF
# KGs are community-structured, which is the premise of the locality
# reorder (parallel/reorder.py); "random" is the locality-free worst case
# where any partition cuts ~(S-1)/S of the edges.
graph_kind = os.environ.get("BENCH_GRAPH", "sbm")
use_reorder = os.environ.get("BENCH_REORDER", "1") != "0"

rng = np.random.default_rng(0)
if graph_kind == "sbm":
    n_comm = int(os.environ.get("BENCH_COMMUNITIES", 64))
    p_in = float(os.environ.get("BENCH_P_IN", 0.9))
    comm = rng.integers(0, n_comm, n)
    order_c = np.argsort(comm, kind="stable")
    csize = np.bincount(comm, minlength=n_comm)
    coff = np.concatenate([[0], np.cumsum(csize)])
    intra = rng.random(e) < p_in
    ei = int(intra.sum())
    ci_ = rng.integers(0, n_comm, ei)
    pick = lambda: order_c[coff[ci_]
                           + (rng.random(ei) * csize[ci_]).astype(np.int64)]
    src = np.empty(e, np.int64)
    dst = np.empty(e, np.int64)
    src[intra], dst[intra] = pick(), pick()
    m = e - ei
    src[~intra] = rng.integers(0, n, m)
    dst[~intra] = rng.integers(0, n, m)
    src = src.astype(np.int32)
    dst = dst.astype(np.int32)
else:
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
typ = rng.integers(0, 2 * r, e).astype(np.int32)
slots = 2 * r + 1

avail = len(jax.devices())
counts = [k for k in (1, 2, 4, 8, 16, 32) if k <= avail]
print(f"backend={jax.default_backend()} devices={avail} -> {counts} "
      f"graph={graph_kind} reorder={use_reorder}", file=sys.stderr, flush=True)

base_eps = None
for k in counts:
    mesh = make_mesh(k)
    src_k, dst_k = src, dst
    if use_reorder and k > 1:
        from scaling_rgcn_training_tpu.parallel import locality_reorder

        perm = locality_reorder(src, dst, n, num_shards=k)
        src_k, dst_k = perm[src], perm[dst]
    hedges = device_put_halo_edges(
        halo_partition_edges(src_k, dst_k, typ, n, slots, k,
                             pad_to_multiple=512),
        mesh)
    n_pad = padded_num_nodes(hedges)
    emb = jax.device_put(jax.random.normal(jax.random.key(0), (n_pad, d)),
                         node_sharding(mesh))
    l1 = init_rgcn_layer(jax.random.key(1), slots, d, hl)
    l2 = init_rgcn_layer(jax.random.key(2), slots, hl, c)
    # replicate the small params on the mesh UP FRONT: otherwise the step's
    # outputs carry mesh shardings its inputs lacked and feeding them back
    # silently recompiles
    from jax.sharding import NamedSharding, PartitionSpec as P
    rep = NamedSharding(mesh, P())
    l1 = jax.device_put(l1, rep)
    l2 = jax.device_put(l2, rep)
    opt = optax.adam(0.01)
    params = (emb, l1, l2)
    state = opt.init(params)   # zeros_like preserves the leaves' shardings
    y = jax.device_put(jax.nn.one_hot(np.arange(1024) % c, c), rep)
    idx = jax.device_put(jnp.arange(1024), rep)

    conv_backend = None
    cd = jnp.bfloat16 if os.environ.get(
        "BENCH_COMPUTE_DTYPE", "").lower() in ("bf16", "bfloat16") else None

    def one_step(ps, st, he):
        def loss_of(p):
            e_, a_, b_ = p
            z = jax.nn.relu(halo_rgcn_conv(e_, he, a_, mesh,
                                           backend=conv_backend,
                                           compute_dtype=cd))
            logits = halo_rgcn_conv(z, he, b_, mesh, backend=conv_backend,
                                    compute_dtype=cd)
            return bce_loss(logits[idx], y)

        loss, grads = jax.value_and_grad(loss_of)(ps)
        updates, st2 = opt.update(grads, st)
        return optax.apply_updates(ps, updates), st2, loss

    # hedges rides as a JIT ARGUMENT (it is a registered pytree): closing
    # over it embeds the multi-million-row plan arrays as HLO literals and
    # XLA CPU constant-folds over them for tens of minutes per arm
    @jax.jit
    def run(ps, st, he):
        def body(cc, _):
            a, b, l = one_step(*cc, he)
            return (a, b), l
        (ps, st), losses = jax.lax.scan(body, (ps, st), None, length=inner)
        return ps, st, losses[-1]

    params, state, loss = run(params, state, hedges)   # compile
    params, state, loss = run(params, state, hedges)   # chained warmup:
    jax.block_until_ready(params)                # sharding-signature drift
    t0 = time.perf_counter()
    for _ in range(calls):
        params, state, loss = run(params, state, hedges)
    jax.block_until_ready(params)
    dt = (time.perf_counter() - t0) / (calls * inner)
    eps = e * 2 / dt  # 2 layers
    if base_eps is None:
        base_eps = eps
    hardware = jax.default_backend()
    # Two efficiency readings:
    # - strong-scaling efficiency T1/(k*Tk): THE number on k real devices,
    #   meaningless on virtual CPU devices that share host cores.
    # - throughput retention (rate at k / rate at 1): on shared-core virtual devices
    #   the ideal is 1.0 (total silicon is constant), so any drop below 1
    #   is the measured partitioning + collective overhead.
    rec = {
        "devices": k, "ms_per_step": round(dt * 1e3, 2),
        "edges_per_s": round(eps, 1),
        "efficiency": round(eps / (base_eps * k), 3),
        "throughput_retention": round(eps / base_eps, 3),
        "hardware": hardware,
        "halo_rows_per_shard": int(hedges.halo) * (k - 1),
        "measures_hardware_scaling": hardware != "cpu",
    }
    print(json.dumps(rec), flush=True)
