"""Per-layer timings behind the conv's dataflow rule and its grouped matmul.

At the bench shape (N=200k, E=4M, 91 slots; layers 64->16 and 16->8) and
the AM shape (N=1.67M, E=12M, 267 slots; layers 63->16 and 16->11), in
float32 and bfloat16:

1. ``relational_aggregate`` forward + backward (value and gradients with
   respect to x and W) in each dataflow: ``edge`` (the tiled grouped
   matmul with its stated transposes, as the package runs it),
   ``edge-autodiff`` (the same tiled product left to autodiff) and
   ``prematmul``; beside each, the mode ``select_mode`` picks.
2. The grouped matmul's forward alone (bfloat16, GPU only): XLA's tiled
   batched matmul, a Pallas kernel through Triton (one 128-row tile per
   program), and JAX's Mosaic GPU library kernels ``ragged_dot_mgpu`` and
   ``transposed_ragged_dot_mgpu`` (the dW form).
3. What XLA makes of ``lax.ragged_dot`` in the edge dataflow: the
   compiled forward + backward's temporary bytes and largest arrays, or
   the compiler's refusal.

Times are the median (and min, max) of ``--reps`` calls after one
warm-up, synchronised with ``jax.block_until_ready``.

    python scripts/time_conv_modes.py [--out results.json]
    python scripts/time_conv_modes.py --tiny     # small shapes, any device
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from scaling_rgcn_training_tpu.ops import build_rel_edges  # noqa: E402
from scaling_rgcn_training_tpu.ops.grouped_matmul import (  # noqa: E402
    TILE, _tile_weights, grouped_matmul)
from scaling_rgcn_training_tpu.ops.rgcn_conv import (  # noqa: E402
    relational_aggregate, select_mode, take_rows)

SHAPES = [("bench", 200_000, 4_000_000, 91, [(64, 16), (16, 8)]),
          ("am", 1_670_000, 12_000_000, 267, [(63, 16), (16, 11)])]
TINY_SHAPES = [("bench", 300, 4000, 9, [(64, 16), (16, 8)]),
               ("am", 400, 5000, 11, [(63, 16), (16, 11)])]
RECORDS = []


def record(**kw):
    RECORDS.append(kw)
    print(json.dumps(kw), flush=True)


def timeit(fn, args, reps):
    """-> (first call s, median ms, min ms, max ms)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return first, float(np.median(ts)), min(ts), max(ts)


def tiled_matmul_autodiff(lhs, rhs, group_sizes):
    """The tiled grouped matmul's forward, without its transpose rule."""
    m, k = lhs.shape
    out = jnp.einsum("tmk,tkn->tmn", lhs.reshape(m // TILE, TILE, k),
                     _tile_weights(rhs, group_sizes, m),
                     preferred_element_type=jnp.float32)
    return out.reshape(m, rhs.shape[2]).astype(lhs.dtype)


def ragged_matmul(lhs, rhs, group_sizes):
    return lax.ragged_dot(lhs, rhs, group_sizes,
                          preferred_element_type=jnp.float32).astype(lhs.dtype)


def edge_aggregate_with(matmul):
    """The edge dataflow of ``relational_aggregate`` over another matmul."""
    def agg(x, w, edges):
        acc = jnp.float32
        msg = matmul(take_rows(x, edges.src), w, edges.group_sizes)
        msg = msg * edges.norm[:, None].astype(acc)
        return jax.ops.segment_sum(msg, edges.dst, num_segments=edges.num_nodes)
    return agg


DATAFLOWS = {
    "edge": lambda x, w, e: relational_aggregate(x, w, e, "edge"),
    "edge-autodiff": edge_aggregate_with(tiled_matmul_autodiff),
    "prematmul": lambda x, w, e: relational_aggregate(x, w, e, "prematmul"),
}


def value_and_grads(agg, edges, g_out):
    def loss(x, w):
        return jnp.vdot(agg(x, w, edges).astype(jnp.float32), g_out)
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))


def triton_grouped_matmul(lhs, rhs, group_sizes):
    """Pallas kernel through Triton: program i multiplies row tile i by its
    group's weight (K and N padded to powers of two, at least 16)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    m, k = lhs.shape
    n_out = rhs.shape[2]
    kp = max(16, 1 << (k - 1).bit_length())
    np_ = max(16, 1 << (n_out - 1).bit_length())
    t = m // TILE
    a = jnp.pad(lhs, ((0, 0), (0, kp - k))).reshape(t, TILE, kp)
    wt = jnp.pad(_tile_weights(rhs, group_sizes, m),
                 ((0, 0), (0, kp - k), (0, np_ - n_out)))

    def kernel(x_ref, w_ref, o_ref):
        o_ref[...] = pl.dot(x_ref[...], w_ref[...]).astype(o_ref.dtype)

    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((t, TILE, np_), lhs.dtype),
        grid=(t,),
        in_specs=[pl.BlockSpec((None, TILE, kp), lambda i: (i, 0, 0)),
                  pl.BlockSpec((None, kp, np_), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((None, TILE, np_), lambda i: (i, 0, 0)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
    )(a, wt)
    return out.reshape(m, np_)[:, :n_out]


def mosaic_ragged_dot(lhs, rhs, group_sizes):
    """JAX's shipped Mosaic GPU ragged dot (K padded to 16, N to 16)."""
    from jax.experimental.pallas.ops.gpu import ragged_dot_mgpu

    k, n_out = lhs.shape[1], rhs.shape[2]
    kp = -(-k // 16) * 16
    np_ = max(16, -(-n_out // 16) * 16)
    out = ragged_dot_mgpu.ragged_dot(
        jnp.pad(lhs, ((0, 0), (0, kp - k))),
        jnp.pad(rhs, ((0, 0), (0, kp - k), (0, np_ - n_out))),
        group_sizes=group_sizes, block_m=128, block_n=np_,
        block_k=min(kp, 64), max_concurrent_steps=2, grid_block_n=1)
    return out[:, :n_out]


def mosaic_transposed_ragged_dot(lhs, ct, group_sizes):
    """JAX's shipped Mosaic GPU dW form: per-group lhs^T @ ct."""
    from jax.experimental.pallas.ops.gpu import transposed_ragged_dot_mgpu

    return transposed_ragged_dot_mgpu.transposed_ragged_dot(
        lhs, ct, group_sizes=group_sizes, block_m=64, block_n=ct.shape[1],
        block_k=64, max_concurrent_steps=2, grid_block_n=1)


def rel_err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def largest_arrays(hlo_text, top=4):
    import re

    sizes = {}
    for m in re.finditer(r"\b([a-z]+[0-9]*)\[([0-9,]+)\]", hlo_text):
        dims = [int(v) for v in m.group(2).split(",") if v]
        sizes[f"{m.group(1)}[{m.group(2)}]"] = int(np.prod(dims))
    return sorted(sizes.items(), key=lambda kv: -kv[1])[:top]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tiny", action="store_true",
                        help="small shapes, for a rehearsal on any device")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--out", default=None, help="write all records here")
    args = parser.parse_args(argv)

    on_gpu = jax.devices()[0].platform == "gpu"
    card = "not a GPU"
    if on_gpu:
        from scaling_rgcn_training_tpu.utils.gpu import card_description

        card = card_description()
    print(f"card: {card}; jax {jax.__version__} {jax.devices()[0].device_kind}",
          flush=True)
    for name, n, e, slots, layers in (TINY_SHAPES if args.tiny else SHAPES):
        rng = np.random.default_rng(0)
        src = rng.integers(0, n, e, dtype=np.int32)
        dst = rng.integers(0, n, e, dtype=np.int32)
        rel = rng.integers(0, slots - 1, e, dtype=np.int32)
        edges = build_rel_edges(src, dst, rel, n, slots)
        e_pad = edges.src.shape[0]
        for d_in, d_out in layers:
            pick = select_mode(n, slots, e_pad, d_in, d_out)
            g_out = jnp.asarray(rng.standard_normal((n, d_out)), jnp.float32)
            for dtype in (jnp.float32, jnp.bfloat16):
                x = jnp.asarray(rng.standard_normal((n, d_in)), dtype)
                w = jnp.asarray(rng.standard_normal((slots, d_in, d_out)) * 0.1,
                                dtype)
                for flow, agg in DATAFLOWS.items():
                    t0 = time.perf_counter()
                    compiled = value_and_grads(agg, edges, g_out).lower(
                        x, w).compile()
                    compile_s = time.perf_counter() - t0
                    _, med, lo, hi = timeit(compiled, (x, w), args.reps)
                    mem = compiled.memory_analysis()
                    record(shape=name, layer=f"{d_in}->{d_out}",
                           dtype=jnp.dtype(dtype).name, dataflow=flow,
                           select_mode=pick, fwdbwd_ms=med, min_ms=lo,
                           max_ms=hi, compile_s=compile_s,
                           temp_bytes=getattr(mem, "temp_size_in_bytes", None))
                # what XLA makes of lax.ragged_dot: compile only; the
                # larger layers fail to compile for want of device memory
                try:
                    compiled = value_and_grads(edge_aggregate_with(
                        ragged_matmul), edges, g_out).lower(x, w).compile()
                    mem = compiled.memory_analysis()
                    record(shape=name, layer=f"{d_in}->{d_out}",
                           dtype=jnp.dtype(dtype).name,
                           dataflow="edge-ragged_dot", compiled_only=True,
                           temp_bytes=getattr(mem, "temp_size_in_bytes", None),
                           largest_arrays=largest_arrays(compiled.as_text()))
                except Exception as exc:  # noqa: BLE001 - record and go on
                    record(shape=name, layer=f"{d_in}->{d_out}",
                           dtype=jnp.dtype(dtype).name,
                           dataflow="edge-ragged_dot",
                           error=f"{type(exc).__name__}: {str(exc)[:300]}")
            if not on_gpu:
                continue
            # the grouped matmul's forward alone, bfloat16
            x = jnp.asarray(rng.standard_normal((n, d_in)), jnp.bfloat16)
            w = jnp.asarray(rng.standard_normal((slots, d_in, d_out)) * 0.1,
                            jnp.bfloat16)
            lhs = jnp.take(x, edges.src, axis=0)
            gs = edges.group_sizes
            ref = jax.jit(grouped_matmul)(lhs, w, gs)
            for route, mm in (("xla-tiled", grouped_matmul),
                              ("pallas-triton", triton_grouped_matmul),
                              ("mosaic-gpu-library ragged_dot",
                               mosaic_ragged_dot)):
                try:
                    fn = jax.jit(mm)
                    _, med, lo, hi = timeit(fn, (lhs, w, gs), args.reps)
                    record(shape=name, layer=f"{d_in}->{d_out}",
                           dtype="bfloat16", grouped_matmul_fwd=route,
                           ms=med, min_ms=lo, max_ms=hi,
                           rel_err_vs_xla=rel_err(fn(lhs, w, gs), ref))
                except Exception as exc:  # noqa: BLE001 - record and go on
                    record(shape=name, layer=f"{d_in}->{d_out}",
                           grouped_matmul_fwd=route,
                           error=f"{type(exc).__name__}: {str(exc)[:300]}")
            try:
                ct = jnp.ones((e_pad, d_out), jnp.bfloat16)
                fn = jax.jit(mosaic_transposed_ragged_dot)
                _, med, lo, hi = timeit(fn, (lhs, ct, gs), args.reps)
                record(shape=name, layer=f"{d_in}->{d_out}", dtype="bfloat16",
                       grouped_matmul_dw="mosaic-gpu-library "
                       "transposed_ragged_dot", ms=med, min_ms=lo, max_ms=hi)
            except Exception as exc:  # noqa: BLE001 - record and go on
                record(shape=name, layer=f"{d_in}->{d_out}",
                       grouped_matmul_dw="mosaic-gpu-library "
                       "transposed_ragged_dot",
                       error=f"{type(exc).__name__}: {str(exc)[:300]}")
        del edges
    print(f"card: {card}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "records": RECORDS}, fh, indent=1)


if __name__ == "__main__":
    main()
