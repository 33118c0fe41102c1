"""Persistent XLA compilation cache (utils/jaxcache.py).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and ``enable()``
sets no directory of its own; otherwise the cache goes to one fixed,
git-ignored directory inside the checkout. A compilation must land there.
"""

import os
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scaling_rgcn_training_tpu.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
    from jax._src import compilation_cache

    compilation_cache.reset_cache()


def test_env_dir_is_honoured_and_nothing_else_set(monkeypatch, tmp_path,
                                                  restore_cache_dir):
    d = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    jax.config.update("jax_compilation_cache_dir", None)
    assert jaxcache.enable() == d
    # enable() set no directory itself: JAX's own reading of the variable
    # is what places the cache
    assert jax.config.jax_compilation_cache_dir is None


def test_default_dir_is_fixed_inside_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxcache.enable()
    assert path == os.path.join(REPO, ".jax_cache")
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path
    # the directory is git-ignored
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_env_var_places_cache_in_fresh_process(tmp_path):
    """A fresh process with the variable set writes its entries there and
    nowhere in the checkout's default directory."""
    d = tmp_path / "xlacache"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from scaling_rgcn_training_tpu.utils import jaxcache\n"
        "print(jaxcache.enable())\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)\n"
        "f = jax.jit(lambda x: jnp.tanh(x @ x.T).sum())\n"
        "print(float(f(jnp.ones((32, 32)))))\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(d),
               JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run(["python", "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[0] == str(d)
    assert any(os.scandir(d)), "no cache entry written"


def test_cache_dir_configured_and_populated(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = jaxcache.enable()
    # the cache backend binds its directory at first use; earlier tests in
    # a full-suite run may already have initialized it elsewhere
    from jax._src import compilation_cache

    compilation_cache.reset_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    try:
        before = set(os.listdir(d))
        salt = float(time.time_ns() % 1_000_003)  # a program not cached yet

        @jax.jit
        def f(x):
            for _ in range(3):
                x = jnp.tanh(x @ x.T) @ x
            return x.sum() + salt

        val = f(jnp.asarray(np.random.default_rng(0).standard_normal(
            (48, 48)), jnp.float32))
        assert np.isfinite(float(val))
        assert set(os.listdir(d)) - before, "no cache entry written"
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
