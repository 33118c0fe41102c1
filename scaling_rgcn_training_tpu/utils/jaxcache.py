"""Persistent XLA compilation cache.

Compiling the train step takes seconds to minutes; the persistent cache
lets every later process with the same program skip it. Call ``enable()``
before the first jit — bench.py, the CLI and chip_smoke.py do.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory. Otherwise the cache lives at a fixed path inside
the checkout (``<repo>/.jax_cache``, git-ignored): the path is part of the
cache's key, so it must not move between runs.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
