"""Capture ONE jax.profiler trace of the bench-shape train step (the
device timeline behind PERF.md's step accounting).

Runs the bench-identical train step (bf16 streams) for a few warmup
calls, then wraps a single call in ``utils.tracing.trace``. The trace
directory is written under ``traces/`` (git-ignored; TensorBoard-loadable;
``xplane.pb`` holds the device timeline).

Run: python scripts/trace_step.py    (env: TRACE_DIR, BENCH_* as bench.py)
"""
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

from scaling_rgcn_training_tpu.models import apply_emb_model, init_emb_model
from scaling_rgcn_training_tpu.ops import build_rel_edges
from scaling_rgcn_training_tpu.train.losses import bce_loss
from scaling_rgcn_training_tpu.train.optim import make_optimizer
from scaling_rgcn_training_tpu.utils import tracing

n = int(os.environ.get("BENCH_NODES", 200_000))
e = int(os.environ.get("BENCH_EDGES", 4_000_000))
r = int(os.environ.get("BENCH_RELS", 45))
d = int(os.environ.get("BENCH_DIM", 64))
hl = int(os.environ.get("BENCH_HIDDEN", 16))
c = 8
out_dir = os.environ.get("TRACE_DIR", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "traces", "bench_step"))

print(f"trace: devices={jax.devices()} -> {out_dir}", flush=True)

rng = np.random.default_rng(0)
src = rng.integers(0, n, e).astype(np.int32)
dst = rng.integers(0, n, e).astype(np.int32)
typ = rng.integers(0, 2 * r, e).astype(np.int32)
slots = 2 * r + 1
edges = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=512)

params = init_emb_model(jax.random.key(0), slots, hl, c, n, d)
optimizer = make_optimizer(0.01, 5e-5)
opt_state = optimizer.init(params)
x_train = jnp.asarray(rng.choice(n, 4096, replace=False).astype(np.int32))
y_train = jax.nn.one_hot(jnp.arange(4096) % c, c)


@jax.jit
def step(params, opt_state, ed):
    def loss_of(p):
        logits = apply_emb_model(p, ed, compute_dtype=jnp.bfloat16)
        return bce_loss(logits[x_train], y_train)

    loss, grads = jax.value_and_grad(loss_of)(params)
    updates, new_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), new_state, loss


t0 = time.perf_counter()
p, s, loss = step(params, opt_state, edges)
jax.block_until_ready((p, s, loss))
print(f"compile+first: {time.perf_counter() - t0:.1f}s", flush=True)
for _ in range(3):
    p, s, loss = step(p, s, edges)
jax.block_until_ready((p, s, loss))

with tracing.trace(out_dir):
    with tracing.annotate("bench_train_step"):
        p, s, loss = step(p, s, edges)
        jax.block_until_ready((p, s, loss))
print("trace written:", out_dir, flush=True)
for root, _, files in os.walk(out_dir):
    for f in files:
        path = os.path.join(root, f)
        print(f"  {os.path.relpath(path, out_dir)} "
              f"{os.path.getsize(path)}", flush=True)
