"""The plain XLA conv path against dense oracles, at the published widths.

- the tiled grouped matmul and the gather oracle against a per-group numpy
  product, with empty and odd-sized groups, in float32 and bfloat16;
- ``rgcn_conv`` in both dataflows against the dense per-relation mean;
- autodiff gradients (x, W, root, bias) against the gradients of that dense
  oracle, with full, basis and block-diagonal weights;
- no per-edge ``[E, d_in, d_out]`` or per-group ``[G, E, .]`` temporary in
  the differentiated program;
- the tile-aligned layout builders.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from scaling_rgcn_training_tpu.ops import (
    build_rel_edges, grouped_matmul, init_rgcn_layer, materialize_weight,
    rgcn_conv)
from scaling_rgcn_training_tpu.ops.grouped_matmul import (
    TILE, aligned_group_layout)

WIDTHS = [(64, 16), (16, 8), (63, 16)]
DTYPES = [jnp.float32, jnp.bfloat16]
# bfloat16 keeps 8 mantissa bits: inputs and messages round at ~4e-3 each
TOL = {jnp.float32: 1e-4, jnp.bfloat16: 3e-2}


def _graph(seed, n=40, e=300, slots=9):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    # slot 2 stays empty, slot 5 is one edge: empty and odd groups
    rel = rng.choice(np.array([0, 1, 3, 4, 6, 7]), e).astype(np.int32)
    rel[:1] = 5
    return src, dst, rel, n, slots


def _dense_conv(x, w, root, bias, src, dst, rel):
    """out = x @ root + bias + sum_r mean_{j -> i in r} x_j @ w[r] (jnp, f32)."""
    n = x.shape[0]
    out = x @ root + bias
    for r in range(w.shape[0]):
        m = jnp.asarray(rel == r, jnp.float32)
        cnt = jax.ops.segment_sum(m, dst, num_segments=n)
        s = jax.ops.segment_sum(x[src] * m[:, None], dst, num_segments=n)
        out = out + (s / jnp.maximum(cnt, 1.0)[:, None]) @ w[r]
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d_in,d_out", WIDTHS)
def test_tiled_grouped_matmul_matches_per_group(d_in, d_out, dtype):
    rng = np.random.default_rng(d_in * 100 + d_out)
    counts = np.array([3, 0, 1, 200, 0, 129, 7], np.int64)
    groups = np.repeat(np.arange(len(counts)), counts)
    pos, sizes = aligned_group_layout(groups, len(counts))
    assert (sizes % TILE == 0).all()
    lhs = np.zeros((int(sizes.sum()), d_in), np.float32)
    lhs[pos] = rng.standard_normal((len(groups), d_in))
    rhs = rng.standard_normal((len(counts), d_in, d_out)).astype(np.float32)
    got = grouped_matmul(jnp.asarray(lhs, dtype), jnp.asarray(rhs, dtype),
                         jnp.asarray(sizes))
    assert got.shape == (lhs.shape[0], d_out) and got.dtype == dtype
    want = np.zeros_like(got, np.float64)
    start = 0
    for g, size in enumerate(sizes):
        want[start:start + size] = lhs[start:start + size] @ rhs[g]
        start += size
    assert _rel(np.asarray(got, np.float32)[pos], want[pos]) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d_in,d_out", WIDTHS)
def test_gather_oracle_matches_per_group_any_layout(d_in, d_out, dtype):
    rng = np.random.default_rng(7 + d_in)
    sizes = np.array([5, 0, 1, 13, 0, 2], np.int32)      # not tile-aligned
    lhs = rng.standard_normal((int(sizes.sum()), d_in)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), d_in, d_out)).astype(np.float32)
    got = grouped_matmul(jnp.asarray(lhs, dtype), jnp.asarray(rhs, dtype),
                         jnp.asarray(sizes), backend="gather")
    want = np.concatenate([lhs[a:b] @ rhs[g] for g, (a, b) in enumerate(
        zip(np.r_[0, np.cumsum(sizes)[:-1]], np.cumsum(sizes)))])
    assert _rel(np.asarray(got, np.float32), want) < TOL[dtype]


@pytest.mark.parametrize("mode", ["edge", "prematmul"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d_in,d_out", WIDTHS)
def test_rgcn_conv_matches_dense(d_in, d_out, dtype, mode):
    src, dst, rel, n, slots = _graph(d_in + d_out)
    key = jax.random.key(d_in)
    p = init_rgcn_layer(key, slots, d_in, d_out)
    p = p._replace(bias=jax.random.normal(jax.random.fold_in(key, 1), (d_out,)))
    x = jax.random.normal(jax.random.fold_in(key, 2), (n, d_in))
    edges = build_rel_edges(src, dst, rel, n, slots, pad_to_multiple=64)
    cd = None if dtype == jnp.float32 else dtype
    got = rgcn_conv(x, edges, p, mode=mode, compute_dtype=cd)
    assert got.dtype == jnp.float32 and got.shape == (n, d_out)
    want = _dense_conv(x, p.weight, p.root, p.bias, src, dst, rel)
    assert _rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("decomposition", ["full", "basis", "block"])
@pytest.mark.parametrize("mode", ["edge", "prematmul"])
def test_autodiff_grads_match_dense_oracle(mode, decomposition):
    src, dst, rel, n, slots = _graph(3)
    d_in, d_out = 8, 6
    key = jax.random.key(11)
    kw = {"basis": dict(num_bases=3), "block": dict(num_blocks=2),
          "full": {}}[decomposition]
    p = init_rgcn_layer(key, slots, d_in, d_out, **kw)
    p = p._replace(bias=jax.random.normal(jax.random.fold_in(key, 1), (d_out,)))
    x = jax.random.normal(jax.random.fold_in(key, 2), (n, d_in))
    g = jax.random.normal(jax.random.fold_in(key, 3), (n, d_out))
    edges = build_rel_edges(src, dst, rel, n, slots, pad_to_multiple=64)

    def loss(params, xv):
        return jnp.vdot(rgcn_conv(xv, edges, params, mode=mode), g)

    def loss_ref(params, xv):
        w = materialize_weight(params)
        return jnp.vdot(_dense_conv(xv, w, params.root, params.bias,
                                    src, dst, rel), g)

    gp, gx = jax.grad(loss, argnums=(0, 1))(p, x)
    rp, rx = jax.grad(loss_ref, argnums=(0, 1))(p, x)
    assert _rel(gx, rx) < 1e-4
    for a, b in zip(jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(rp)):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("mode", ["edge", "prematmul"])
def test_no_per_edge_outer_product_in_backward(mode):
    """The differentiated conv holds no [E, d_in, d_out] or [G, E, .]
    value: the backward is two batched matmuls, gathers and scatters."""
    n, e, slots, d_in, d_out = 300, 5000, 11, 63, 16
    src, dst, rel, _, _ = _graph(5, n=n, e=e, slots=slots)
    edges = build_rel_edges(src, dst, rel, n, slots)
    p = init_rgcn_layer(jax.random.key(0), slots, d_in, d_out)
    x = jnp.ones((n, d_in))

    def loss(params, xv):
        return rgcn_conv(xv, edges, params, mode=mode).sum()

    jaxpr = jax.make_jaxpr(jax.grad(loss, argnums=(0, 1)))(p, x)
    e_pad = edges.src.shape[0]
    shapes = set()

    def walk(jx):
        for eqn in jx.eqns:
            for v in eqn.outvars:
                shapes.add(tuple(getattr(v.aval, "shape", ())))
            for val in eqn.params.values():
                for sub in (val if isinstance(val, (tuple, list)) else (val,)):
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        walk(sub.jaxpr)                   # ClosedJaxpr
                    elif hasattr(sub, "eqns"):
                        walk(sub)                         # Jaxpr

    walk(jaxpr.jaxpr)
    biggest = max(int(np.prod(s)) for s in shapes)
    assert biggest <= e_pad * d_in, (biggest, sorted(shapes, key=np.prod)[-3:])
    assert (e_pad, d_in, d_out) not in shapes
    assert not any(len(s) == 3 and s[0] == slots and s[1] == e_pad for s in shapes)


@pytest.mark.parametrize("multiple", [1, 64, 512, 1000])
def test_aligned_group_layout(multiple):
    rng = np.random.default_rng(multiple)
    groups = np.sort(rng.integers(0, 7, 1000))
    groups[groups == 3] = 2                          # an empty group
    pos, sizes = aligned_group_layout(groups, 8, multiple)
    assert (sizes % TILE == 0).all() and sizes[3] == 0
    total = int(sizes.sum())
    assert total % multiple == 0 and total % TILE == 0
    assert len(np.unique(pos)) == len(pos) and pos.max() < total
    # each row lands inside its own group's range, in order
    ends = np.cumsum(sizes)
    starts = ends - sizes
    assert ((pos >= starts[groups]) & (pos < ends[groups])).all()
    assert (np.diff(pos) > 0).all()


def test_partition_builders_are_tile_aligned():
    from scaling_rgcn_training_tpu.parallel import (
        halo_partition_edges, shard_rel_edges)

    src, dst, rel, n, slots = _graph(9, n=64, e=900)
    for gs in (shard_rel_edges(src, dst, rel, n, slots, 4, 8).group_sizes,
               halo_partition_edges(src, dst, rel, n, slots, 4, 8, 4).lgs,
               halo_partition_edges(src, dst, rel, n, slots, 4, 8, 4).hgs):
        gs = np.asarray(gs)
        assert (gs % TILE == 0).all(), gs
    edges = build_rel_edges(src, dst, rel, n, slots, pad_to_multiple=8)
    assert (np.asarray(edges.group_sizes) % TILE == 0).all()
    real = np.asarray(edges.norm) > 0
    assert real.sum() == len(src)
    # rel is the row's slot, consistent with group_sizes
    want = np.repeat(np.arange(slots), np.asarray(edges.group_sizes))
    assert (np.asarray(edges.rel) == want).all()


@pytest.mark.parametrize("shape,want", [
    ((200_000, 91, 4_005_248, 64, 16), "prematmul"),   # bench layer 1
    ((200_000, 91, 4_005_248, 16, 8), "edge"),         # bench layer 2
    ((1_670_000, 267, 12_016_384, 63, 16), "edge"),    # AM layer 1
    ((1_670_000, 267, 12_016_384, 16, 11), "edge"),    # AM layer 2
    ((8_285, 91, 70_000, 63, 16), "edge"),             # AIFB-shaped layer 1
    ((1_000, 9, 100_000, 16, 16), "edge"),             # d_out == d_in
])
def test_select_mode_rule(shape, want):
    """The shape rule reproduces the dataflow that measured faster in
    float32 on the H100 at the bench and AM shapes (PERF.md)."""
    from scaling_rgcn_training_tpu.ops.rgcn_conv import select_mode

    assert select_mode(*shape) == want
