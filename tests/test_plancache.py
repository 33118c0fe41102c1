"""On-disk edge-plan cache: roundtrip fidelity, hits, and invalidation.

Greenfield subsystem (the reference rebuilds all preprocessing per run,
reference main.py:46-47); at AM scale the plan build costs minutes per
process, so correctness of the cache path matters.
"""

import os

import numpy as np
import pytest

from scaling_rgcn_training_tpu.ops import build_rel_edges
from scaling_rgcn_training_tpu.parallel import halo_partition_edges
from scaling_rgcn_training_tpu.utils import plancache


def _graph(seed=0, n=200, e=1500, r=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, 2 * r, e).astype(np.int32), n, 2 * r + 1)


def _trees_equal(a, b):
    import jax

    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(la, lb))


def test_rel_edges_cache_roundtrip(tmp_path):
    src, dst, typ, n, slots = _graph()
    fresh = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=64)
    d = str(tmp_path)
    built = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=64,
                            cache_dir=d)
    files = [f for f in os.listdir(d) if f.endswith(".plan")]
    assert len(files) == 1
    loaded = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=64,
                             cache_dir=d)
    assert _trees_equal(fresh, built)
    assert _trees_equal(fresh, loaded)


def test_halo_edges_cache_roundtrip(tmp_path):
    src, dst, typ, n, slots = _graph(seed=3)
    fresh = halo_partition_edges(src, dst, typ, n, slots, 4,
                                 pad_to_multiple=8, halo_multiple=4)
    d = str(tmp_path)
    halo_partition_edges(src, dst, typ, n, slots, 4, pad_to_multiple=8,
                         halo_multiple=4, cache_dir=d)
    loaded = halo_partition_edges(src, dst, typ, n, slots, 4,
                                  pad_to_multiple=8, halo_multiple=4,
                                  cache_dir=d)
    assert _trees_equal(fresh, loaded)


def test_cache_key_sensitivity(tmp_path):
    src, dst, typ, n, slots = _graph(seed=5)
    d = str(tmp_path)
    build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=64, cache_dir=d)
    # different graph content -> different entry
    build_rel_edges(src, dst, typ + 0 * typ, n, slots, pad_to_multiple=128,
                    cache_dir=d)
    # different layout argument -> different entry
    build_rel_edges(src, dst, typ, n, slots + 1, pad_to_multiple=64,
                    cache_dir=d)
    files = [f for f in os.listdir(d) if f.endswith(".plan")]
    assert len(files) == 3


def test_corrupt_entry_rebuilds(tmp_path):
    src, dst, typ, n, slots = _graph(seed=7)
    d = str(tmp_path)
    fresh = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=64,
                            cache_dir=d)
    (path,) = [os.path.join(d, f) for f in os.listdir(d)
               if f.endswith(".plan")]
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    rebuilt = build_rel_edges(src, dst, typ, n, slots, pad_to_multiple=64,
                              cache_dir=d)
    assert _trees_equal(fresh, rebuilt)


def test_plan_key_stable():
    src, dst, typ, n, slots = _graph(seed=9)
    k1 = plancache.plan_key("reledges", (src, dst, typ), (n, slots, 64))
    k2 = plancache.plan_key("reledges", (src, dst, typ), (n, slots, 64))
    k3 = plancache.plan_key("reledges", (src, dst, typ), (n, slots, 128))
    assert k1 == k2 and k1 != k3
