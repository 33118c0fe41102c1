"""On-disk cache for host-built edge plans (RelEdges / halo partitions).

Plan construction is host-side preprocessing that runs once per graph
(ops/rgcn_conv.py `build_rel_edges`, parallel/halo.py
`halo_partition_edges`). At AM scale (~12M directed edges) a cold build
costs minutes per process even with the native packer — the reference
rebuilds everything per run (reference main.py:46-47), but a framework
meant for repeated large-scale training should not. This cache persists
the finished plan pytrees keyed by a content hash of the raw edge arrays
plus every argument that shapes the plan, so the second process start
loads in seconds.

Format: one pickle per plan holding the NamedTuple pytree with all array
leaves converted to host numpy (atomic rename on write). The key hashes
the *inputs*, so any edit to the raw graph or the layout arguments misses
cleanly; `_VERSION` must be bumped whenever the plan layout changes.

Trust model: plans are PICKLES. Loading executes whatever the file says,
so the cache dir must be private to the user/job (the default — a local
path the trainer owns). Do NOT point ``plan_cache`` at a directory other
principals can write to (e.g. a world-writable shared checkpoint dir).
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Callable, Iterable

import numpy as np

# bump when any plan NamedTuple layout changes
_VERSION = 9  # v9: RelEdges / HaloShardedEdges without kernel plans


def plan_key(kind: str, arrays: Iterable[np.ndarray], statics: tuple) -> str:
    """Content hash of raw inputs + layout arguments + format version."""
    h = hashlib.blake2b(digest_size=20)
    h.update(f"{kind}|v{_VERSION}|{statics!r}".encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"|{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _to_host(obj):
    import jax

    return jax.tree_util.tree_map(np.asarray, obj)


def to_device(obj):
    """Convert a host-built (numpy-leaf) plan pytree to device arrays.

    Builders construct plans entirely in numpy so that caching never
    fetches arrays back from the accelerator; this is the one conversion
    point."""
    import jax
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, obj)


_to_device = to_device


def save_plan(path: str, obj) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(obj), f, protocol=4)
    os.replace(tmp, path)


def load_plan(path: str):
    with open(path, "rb") as f:
        return _to_device(pickle.load(f))


def get_or_build(cache_dir: str | None, kind: str,
                 arrays: Iterable[np.ndarray], statics: tuple,
                 build: Callable[[], object]):
    """Load the cached plan for (kind, inputs) or build + persist it.

    ``build`` must return a HOST (numpy-leaf) plan; the result is
    converted to device arrays on the way out. ``cache_dir=None`` (or
    empty) disables caching.
    """
    if not cache_dir:
        return to_device(build())
    arrays = [np.asarray(a) for a in arrays]
    key = plan_key(kind, arrays, statics)
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{kind}-{key}.plan")
    if os.path.exists(path):
        try:
            return load_plan(path)
        except (pickle.UnpicklingError, EOFError, OSError, ValueError,
                AttributeError, ImportError) as e:
            # corrupt/partial/stale-format file: rebuild and overwrite —
            # but say so, a silently-discarded cache hides real I/O issues
            import warnings

            warnings.warn(f"discarding unreadable plan cache entry "
                          f"{path}: {type(e).__name__}: {e}", stacklevel=2)
    obj = build()
    save_plan(path, obj)
    return to_device(obj)
