"""Device mesh management.

One mesh axis, ``"e"`` (edges), is the workhorse: the per-relation edge
list is partitioned across it and partial aggregations ride an
all-reduce (NCCL on GPUs). Multi-host initialization goes through
``jax.distributed.initialize`` before mesh construction.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

_current_mesh: Optional[Mesh] = None

EDGE_AXIS = "e"


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = (EDGE_AXIS,)) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    assert n <= len(devices), f"asked for {n} devices, have {len(devices)}"
    return Mesh(np.array(devices[:n]).reshape(n), axis_names=tuple(axis_names))


def current_mesh() -> Optional[Mesh]:
    return _current_mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Ambient mesh for the sharded conv dispatch (ops/rgcn_conv.py)."""
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = prev


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (the NCCL-init equivalent; no-op when single).

    After this returns, ``jax.devices()`` is the GLOBAL device list across
    all processes and ``make_mesh`` builds a mesh spanning hosts; the halo
    all_to_all then crosses the process boundary.
    Exercised end-to-end (2 processes x 4 virtual CPU devices) by
    ``scripts/multihost_sim.py`` / ``tests/test_multihost.py``.
    """
    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)


def put_global(a, sharding):
    """Place a host array onto a (possibly multi-process) sharding.

    Single-controller: plain ``device_put``. Multi-controller: every
    process holds the full host value and contributes only its addressable
    shards (``make_array_from_callback`` — the standard multi-host
    ingestion pattern; ``device_put`` would need all devices addressable).
    """
    import numpy as _np

    if jax.process_count() == 1:
        return jax.device_put(a, sharding)
    a = _np.asarray(a)
    return jax.make_array_from_callback(a.shape, sharding, lambda idx: a[idx])
