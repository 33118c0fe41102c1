"""Golden-value tests for the grouped matmul and the R-GCN conv op.

The correctness oracle is a dense numpy implementation of the reference
semantics (PyG RGCNConv with aggr='mean', root_weight, bias — SURVEY.md L0):

    out_i = x_i @ root + bias + sum_r ( mean_{j in N_r(i)} x_j ) @ W[r]
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from scaling_rgcn_training_tpu.ops import (
    RGCNLayerParams,
    build_rel_edges,
    grouped_matmul,
    init_rgcn_layer,
    materialize_weight,
    rgcn_conv,
)


def dense_rgcn_reference(x, src, dst, typ, w, root, bias):
    """Dense per-relation mean aggregation, straight from the math."""
    n, _ = x.shape
    r_slots = w.shape[0]
    out = x @ root + bias
    for r in range(r_slots):
        mask = typ == r
        if not mask.any():
            continue
        s, d = src[mask], dst[mask]
        agg = np.zeros((n, x.shape[1]), np.float64)
        cnt = np.zeros(n, np.float64)
        for si, di in zip(s, d):
            agg[di] += x[si]
            cnt[di] += 1
        nz = cnt > 0
        agg[nz] /= cnt[nz, None]
        out += agg @ w[r]
    return out


def random_graph(rng, n=23, e=77, r=4, d=8):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)  # slots 0..2r-1; 2r empty
    x = rng.standard_normal((n, d)).astype(np.float32)
    return src, dst, typ, x


@pytest.mark.parametrize("backend", ["gather", "tiled"])
def test_grouped_matmul_backends(backend):
    from scaling_rgcn_training_tpu.ops.grouped_matmul import TILE

    rng = np.random.default_rng(0)
    k, n, g = 8, 5, 6
    # the tiled backend takes tile-aligned groups; the gather oracle any
    unit = TILE if backend == "tiled" else 1
    sizes = np.array([7, 0, 13, 5, 15, 0], np.int32) * unit
    m = int(sizes.sum())
    lhs = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
    rhs = jnp.asarray(rng.standard_normal((g, k, n)), jnp.float32)
    out = grouped_matmul(lhs, rhs, jnp.asarray(sizes), backend=backend)
    ref, start = np.zeros((m, n), np.float32), 0
    for i, s in enumerate(sizes):
        ref[start:start + s] = np.asarray(lhs[start:start + s]) @ np.asarray(rhs[i])
        start += s
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("backend", ["gather", "tiled"])
def test_rgcn_conv_matches_dense_reference(backend):
    rng = np.random.default_rng(1)
    n, e, r, d_in, d_out = 23, 77, 4, 8, 5
    src, dst, typ, x = random_graph(rng, n, e, r, d_in)
    slots = 2 * r + 1
    w = rng.standard_normal((slots, d_in, d_out)).astype(np.float32)
    root = rng.standard_normal((d_in, d_out)).astype(np.float32)
    bias = rng.standard_normal(d_out).astype(np.float32)

    edges = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=64)
    params = RGCNLayerParams(jnp.asarray(w), jnp.asarray(root), jnp.asarray(bias))
    out = rgcn_conv(jnp.asarray(x), edges, params, backend=backend)

    ref = dense_rgcn_reference(
        x.astype(np.float64), src, dst, typ, w.astype(np.float64),
        root.astype(np.float64), bias.astype(np.float64))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-2, atol=2e-2)


def test_rgcn_conv_jit_and_grad():
    rng = np.random.default_rng(2)
    n, e, r, d_in, d_out = 16, 40, 3, 4, 3
    src, dst, typ, x = random_graph(rng, n, e, r, d_in)
    slots = 2 * r + 1
    params = init_rgcn_layer(jax.random.key(0), slots, d_in, d_out)
    # padding rows must be inert: gradients identical with light vs. heavy
    # padding (every slot is padded to whole tiles, so some is always there;
    # the heavy layout adds thousands of rows to the final slot), through
    # the gather oracle and the default tiled grouped matmul
    edges_light = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=8)
    edges_heavy = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=4096)
    assert len(edges_heavy.src) >= len(edges_light.src) + 2048
    assert len(edges_light.src) >= e

    def grads(edges, backend):
        def loss(p, xv):
            return jnp.sum(rgcn_conv(xv, edges, p, backend=backend,
                                     mode="edge") ** 2)

        return jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))

    for backend in ("gather", "tiled"):
        g_params, g_x = grads(edges_heavy, backend)
        assert g_params.weight.shape == (slots, d_in, d_out)
        assert g_x.shape == x.shape
        assert np.isfinite(np.asarray(g_params.weight)).all()
        g2_params, g2_x = grads(edges_light, backend)
        np.testing.assert_allclose(np.asarray(g_x), np.asarray(g2_x),
                                   rtol=1e-5, atol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(g_params),
                        jax.tree_util.tree_leaves(g2_params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6)


def test_basis_decomposition():
    rng = np.random.default_rng(3)
    slots, d_in, d_out, b = 7, 6, 4, 3
    params = init_rgcn_layer(jax.random.key(1), slots, d_in, d_out, num_bases=b)
    assert params.weight.shape == (b, d_in, d_out)
    assert params.comp.shape == (slots, b)
    w = materialize_weight(params)
    assert w.shape == (slots, d_in, d_out)
    ref = np.einsum("rb,bio->rio", np.asarray(params.comp), np.asarray(params.weight))
    np.testing.assert_allclose(np.asarray(w), ref, rtol=1e-5, atol=1e-5)


def test_block_diagonal_decomposition():
    slots, d_in, d_out, nb = 5, 6, 4, 2
    params = init_rgcn_layer(jax.random.key(2), slots, d_in, d_out, num_blocks=nb)
    assert params.weight.shape == (slots, nb, d_in // nb, d_out // nb)
    w = np.asarray(materialize_weight(params))
    assert w.shape == (slots, d_in, d_out)
    # off-diagonal blocks are zero
    assert np.all(w[:, :3, 2:] == 0)
    assert np.all(w[:, 3:, :2] == 0)
    np.testing.assert_allclose(w[:, :3, :2], np.asarray(params.weight)[:, 0])
    np.testing.assert_allclose(w[:, 3:, 2:], np.asarray(params.weight)[:, 1])


def test_conv_with_basis_matches_materialized():
    rng = np.random.default_rng(4)
    n, e, r, d_in, d_out = 12, 30, 2, 4, 4
    src, dst, typ, x = random_graph(rng, n, e, r, d_in)
    slots = 2 * r + 1
    edges = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=32)
    p_basis = init_rgcn_layer(jax.random.key(3), slots, d_in, d_out, num_bases=2)
    p_full = RGCNLayerParams(materialize_weight(p_basis), p_basis.root, p_basis.bias)
    out_b = rgcn_conv(jnp.asarray(x), edges, p_basis, backend="gather")
    out_f = rgcn_conv(jnp.asarray(x), edges, p_full, backend="gather")
    np.testing.assert_allclose(np.asarray(out_b), np.asarray(out_f), rtol=1e-5, atol=1e-5)


def test_init_distributions():
    # kaiming_uniform fan_in bound on [R, in, out]: sqrt(6/(in*out))
    slots, d_in, d_out = 9, 63, 16
    params = init_rgcn_layer(jax.random.key(4), slots, d_in, d_out)
    w = np.asarray(params.weight)
    bound = np.sqrt(6.0 / (d_in * d_out))
    assert np.abs(w).max() <= bound
    assert np.abs(w).max() > 0.8 * bound  # actually fills the range
    r = np.asarray(params.root)
    bound_r = np.sqrt(6.0 / (d_in + d_out))
    assert np.abs(r).max() <= bound_r
    assert np.all(np.asarray(params.bias) == 0)


@pytest.mark.parametrize("mode", ["edge", "prematmul"])
def test_custom_vjp_matches_autodiff(mode):
    """relational_aggregate's backward (autodiff through the tiled grouped
    matmul / the prematmul gather) == autodiff of the gather oracle."""
    from scaling_rgcn_training_tpu.ops.rgcn_conv import relational_aggregate

    rng = np.random.default_rng(7)
    n, e, r, d_in, d_out = 30, 111, 3, 8, 5
    src, dst, typ, x = random_graph(rng, n, e, r, d_in)
    slots = 2 * r + 1
    edges = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=64)
    w = jnp.asarray(rng.standard_normal((slots, d_in, d_out)), jnp.float32)
    xj = jnp.asarray(x)
    g_out = jnp.asarray(rng.standard_normal((n, d_out)), jnp.float32)

    def loss_custom(xv, wv):
        return jnp.vdot(relational_aggregate(xv, wv, edges, mode, "tiled"), g_out)

    def loss_auto(xv, wv):
        return jnp.vdot(relational_aggregate(xv, wv, edges, "edge", "gather"), g_out)

    gx_c, gw_c = jax.grad(loss_custom, argnums=(0, 1))(xj, w)
    gx_a, gw_a = jax.grad(loss_auto, argnums=(0, 1))(xj, w)
    np.testing.assert_allclose(np.asarray(gx_c), np.asarray(gx_a), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gw_c), np.asarray(gw_a), rtol=1e-4, atol=1e-5)
