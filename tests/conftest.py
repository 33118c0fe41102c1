"""Test harness: force an 8-device CPU JAX backend before jax initializes.

Multi-device sharding (shard_map / pjit over a Mesh) is tested on a virtual
8-device CPU mesh — the standard JAX fake-backend trick — so the tests run
on any machine, with or without an accelerator.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # tests never touch an accelerator
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Some environments pre-import jax via a pytest plugin, in which case jax has
# already read JAX_PLATFORMS from the environment; config.update works as
# long as no backend has initialized yet.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

REFERENCE_GRAPHS = "/root/reference/graphs"


@pytest.fixture(scope="session")
def ref_graphs_dir():
    if not os.path.isdir(REFERENCE_GRAPHS):
        pytest.skip("reference dataset fixtures not available")
    return REFERENCE_GRAPHS
