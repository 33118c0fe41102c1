"""Node-partitioned halo-exchange SPMD on a virtual 8-device CPU mesh.

Oracle: the single-device conv (ops/rgcn_conv.py, gather backend) on the
same graph — values and gradients must match, since the halo path is only
a dataflow change (SURVEY.md L0 semantics are identical).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from scaling_rgcn_training_tpu.ops import build_rel_edges, rgcn_conv, init_rgcn_layer
from scaling_rgcn_training_tpu.parallel import (
    make_mesh, use_mesh, halo_partition_edges, halo_rgcn_conv,
    device_put_halo_edges, pad_node_array, padded_num_nodes, node_sharding)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(8)


def _random_graph(seed=0, n=53, e=337, r=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, 2 * r, e).astype(np.int32), n, 2 * r + 1)


def _setup(mesh, seed=0, d=8, h=6):
    src, dst, typ, n, slots = _random_graph(seed)
    rng = np.random.default_rng(seed + 100)
    x = jnp.asarray(rng.standard_normal((n, d)), jnp.float32)
    params = init_rgcn_layer(jax.random.key(seed), slots, d, h)
    dense = build_rel_edges(src, dst, typ, n, slots, 64)
    hedges = device_put_halo_edges(
        halo_partition_edges(src, dst, typ, n, slots, 8, pad_to_multiple=8,
                             halo_multiple=4), mesh)
    xp = jax.device_put(pad_node_array(x, hedges), node_sharding(mesh))
    return x, xp, params, dense, hedges, n


def test_halo_conv_matches_dense(mesh8):
    x, xp, params, dense, hedges, n = _setup(mesh8)
    want = rgcn_conv(x, dense, params, backend="gather")
    got = halo_rgcn_conv(xp, hedges, params, mesh8, backend="gather")
    assert got.shape[0] == padded_num_nodes(hedges)
    np.testing.assert_allclose(np.asarray(got)[:n], np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_halo_conv_grads_match(mesh8):
    x, xp, params, dense, hedges, n = _setup(mesh8, seed=2)

    gd = jax.grad(lambda p, xv: jnp.sum(
        rgcn_conv(xv, dense, p, backend="gather") ** 2), argnums=(0, 1)
    )(params, x)
    gh = jax.grad(lambda p, xv: jnp.sum(
        halo_rgcn_conv(xv, hedges, p, mesh8, backend="gather")[:n] ** 2),
        argnums=(0, 1))(params, xp)
    # param grads match exactly in structure; x grad only over real rows
    for a, b in zip(jax.tree_util.tree_leaves(gd[0]),
                    jax.tree_util.tree_leaves(gh[0])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gh[1])[:n], np.asarray(gd[1]),
                               rtol=1e-3, atol=1e-4)


def test_halo_conv_bf16_streams(mesh8):
    """compute_dtype=bfloat16 reaches the distributed path (it was
    silently dropped by the dispatch until r4): bf16 per-edge streams —
    including the exchange bytes — f32 reductions, output close to f32."""
    x, xp, params, dense, hedges, n = _setup(mesh8, seed=4)
    want = rgcn_conv(x, dense, params, backend="gather")
    got = halo_rgcn_conv(xp, hedges, params, mesh8, backend="gather",
                         compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(
        np.asarray(got)[:n], np.asarray(want), rtol=3e-2,
        atol=3e-2 * float(np.abs(np.asarray(want)).max()))


def test_halo_dispatch_via_use_mesh(mesh8):
    x, xp, params, dense, hedges, n = _setup(mesh8, seed=3)
    want = rgcn_conv(x, dense, params, backend="gather")
    with use_mesh(mesh8):
        got = rgcn_conv(xp, hedges, params, backend="gather")
    np.testing.assert_allclose(np.asarray(got)[:n], np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_halo_two_layer_jit_train_step(mesh8):
    """Full 2-layer node-sharded train step under jit: loss decreases."""
    import optax

    src, dst, typ, n, slots = _random_graph(seed=5, n=64, e=400, r=3)
    hedges = device_put_halo_edges(
        halo_partition_edges(src, dst, typ, n, slots, 8, pad_to_multiple=8,
                             halo_multiple=4), mesh8)
    n_pad = padded_num_nodes(hedges)
    d, hl, c = 8, 6, 3
    k = jax.random.key(7)
    emb = jax.device_put(jax.random.normal(k, (n_pad, d)), node_sharding(mesh8))
    p1 = init_rgcn_layer(jax.random.fold_in(k, 1), slots, d, hl)
    p2 = init_rgcn_layer(jax.random.fold_in(k, 2), slots, hl, c)
    params = (emb, p1, p2)
    y = jax.nn.one_hot(np.arange(32) % c, c)
    idx = jnp.arange(32)

    opt = optax.adam(0.05)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        def loss_of(ps):
            e_, a_, b_ = ps
            z = halo_rgcn_conv(e_, hedges, a_, mesh8, backend="gather")
            z = jax.nn.relu(z)
            z = halo_rgcn_conv(z, hedges, b_, mesh8, backend="gather")
            logits = z[idx]
            return optax.softmax_cross_entropy(logits, y).mean()

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, state2 = opt.update(grads, state)
        return optax.apply_updates(params, updates), state2, loss

    losses = []
    for _ in range(8):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_halo_partition_structure():
    """Every edge lands on its dst owner; norms are the global means."""
    src, dst, typ, n, slots = _random_graph(seed=6, n=40, e=200, r=3)
    he = halo_partition_edges(src, dst, typ, n, slots, 4, pad_to_multiple=8,
                              halo_multiple=4)
    n_per = he.n_per
    total = 0
    for seg_dst, seg_norm in [(he.ldst, he.lnorm), (he.hdst, he.hnorm)]:
        seg_dst, seg_norm = np.asarray(seg_dst), np.asarray(seg_norm)
        for s in range(4):
            real = seg_norm[s] > 0
            total += int(real.sum())
            assert (seg_dst[s][real] < n_per).all()
    assert total == len(src)
    # per-(rel, dst) mean coefficients sum to 1 per group, so the total
    # equals the number of distinct (rel, dst) groups
    keys = typ.astype(np.int64) * n + dst.astype(np.int64)
    assert np.isclose(np.asarray(he.lnorm).sum() + np.asarray(he.hnorm).sum(),
                      len(np.unique(keys)))


def test_halo_powerlaw_hub_graph(mesh8):
    """Hub-heavy (Zipf) degree distribution: correctness + halo-buffer
    sanity. Hubs are read by every shard, the worst case for the
    per-(reader, owner) halo sizing (VERDICT weak #5)."""
    rng = np.random.default_rng(11)
    n, e, r = 64, 600, 3
    slots = 2 * r + 1
    # Zipf-distributed endpoints -> a handful of hub nodes carry most edges
    zipf = lambda size: np.minimum(rng.zipf(1.6, size) - 1, n - 1).astype(np.int32)
    src, dst = zipf(e), zipf(e)
    typ = rng.integers(0, 2 * r, e).astype(np.int32)

    he = halo_partition_edges(src, dst, typ, n, slots, 8, pad_to_multiple=8,
                              halo_multiple=4)
    # halo buffer can never exceed the owner's node range
    assert he.halo <= max(8, he.n_per + 4)

    x = jnp.asarray(rng.standard_normal((n, 8)), jnp.float32)
    params = init_rgcn_layer(jax.random.key(7), slots, 8, 6)
    dense = build_rel_edges(src, dst, typ, n, slots, 64)
    want = rgcn_conv(x, dense, params, backend="gather")
    hedges = device_put_halo_edges(he, mesh8)
    xp = jax.device_put(pad_node_array(x, hedges), node_sharding(mesh8))
    got = halo_rgcn_conv(xp, hedges, params, mesh8, backend="gather")
    np.testing.assert_allclose(np.asarray(got)[:n], np.asarray(want),
                               rtol=1e-4, atol=1e-5)
