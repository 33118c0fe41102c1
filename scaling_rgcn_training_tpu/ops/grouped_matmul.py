"""Grouped matrix multiply: the per-edge relational transform.

``grouped_matmul(lhs, rhs, group_sizes)`` computes, for rows of ``lhs``
partitioned into ``G`` consecutive groups of sizes ``group_sizes[g]``,

    out[rows of group g] = lhs[rows of group g] @ rhs[g]

with ``lhs: [M, K]``, ``rhs: [G, K, N]``, ``out: [M, N]``. This is the MoE
grouped-matmul shape, which is why the framework stores graph edges sorted
by relation: the reference's R-per-relation masked passes inside PyG
``RGCNConv`` (see SURVEY.md L0) collapse into one op whose FLOP count is
proportional to the number of edges, not nodes x relations.

Backends:
- ``"tiled"`` (the default) — rows are cut into tiles of ``TILE`` rows and
  each tile is multiplied by its group's weight: one batched matmul
  ``[M/TILE, TILE, K] @ [M/TILE, K, N]``. Requires the tile-aligned layout
  of :func:`aligned_group_layout` (every group size a multiple of
  ``TILE``), which every edge builder in this package produces. Its
  gradient is two more batched matmuls and a segment-sum of per-tile
  weight gradients, so no temporary is larger than the ``[M, K]`` input.
- ``"gather"`` — per-row weight gather + batched matmul. Any layout;
  O(M*K*N) FLOPs and an ``[M, K, N]`` temporary: the correctness oracle
  for tests and small graphs.

``lax.ragged_dot`` is not used: XLA lowers it, on the GPU as on the CPU, to
a dense expansion over all G groups (``[M, G, K]`` temporaries).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# rows per tile of the "tiled" backend; every group is padded to a multiple
TILE = 128


def aligned_group_layout(groups: np.ndarray, num_groups: int,
                         multiple: int = 1):
    """Host-side tile-aligned layout for rows already sorted by group.

    Every group is padded to a multiple of ``TILE`` rows, and the last
    group takes extra padding so the total is a multiple of
    ``lcm(TILE, multiple)``. Returns ``(pos, group_sizes)``: input row
    ``i`` goes to output row ``pos[i]``; ``group_sizes`` (int32
    ``[num_groups]``) are the padded sizes. Padding rows are the caller's
    to fill (with a zero coefficient).
    """
    groups = np.asarray(groups, np.int64)
    counts = np.bincount(groups, minlength=num_groups).astype(np.int64)
    sizes = -(-counts // TILE) * TILE
    step = int(np.lcm(TILE, max(1, int(multiple))))
    total = int(sizes.sum())
    sizes[num_groups - 1] += max(step, -(-total // step) * step) - total
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(groups)) - first[groups] + starts[groups]
    return pos, sizes.astype(np.int32)


def group_ids_from_sizes(group_sizes: jnp.ndarray, num_rows: int,
                         row_step: int = 1) -> jnp.ndarray:
    """Group id of rows ``0, row_step, 2*row_step, ...`` (jit-safe)."""
    ends = jnp.cumsum(group_sizes)
    rows = jnp.arange(0, num_rows, row_step, dtype=group_sizes.dtype)
    gid = jnp.searchsorted(ends, rows, side="right")
    return jnp.minimum(gid, group_sizes.shape[0] - 1).astype(jnp.int32)


def _gather_backend(lhs: jnp.ndarray, rhs: jnp.ndarray, group_sizes: jnp.ndarray) -> jnp.ndarray:
    gid = group_ids_from_sizes(group_sizes, lhs.shape[0])
    w = rhs[gid]  # [M, K, N]
    return jnp.einsum(
        "mk,mkn->mn", lhs, w, preferred_element_type=jnp.float32
    ).astype(lhs.dtype)


def _tile_weights(rhs, group_sizes, m):
    return jnp.take(rhs, group_ids_from_sizes(group_sizes, m, TILE), axis=0)


@jax.custom_vjp
def _tiled_backend(lhs: jnp.ndarray, rhs: jnp.ndarray, group_sizes: jnp.ndarray) -> jnp.ndarray:
    m, k = lhs.shape
    if m % TILE:
        raise ValueError(f"tiled grouped_matmul needs rows % {TILE} == 0, got {m}")
    out = jnp.einsum("tmk,tkn->tmn", lhs.reshape(m // TILE, TILE, k),
                     _tile_weights(rhs, group_sizes, m),
                     preferred_element_type=jnp.float32)
    return out.reshape(m, rhs.shape[2]).astype(lhs.dtype)


def _tiled_fwd(lhs, rhs, group_sizes):
    return _tiled_backend(lhs, rhs, group_sizes), (lhs, rhs, group_sizes)


def _tiled_bwd(res, ct):
    """The two transposed batched matmuls autodiff would emit, with float32
    accumulation stated explicitly: XLA's GPU lowering of autodiff's own
    bfloat16 transposes measured 3-12x slower per layer (PERF.md)."""
    lhs, rhs, group_sizes = res
    m, k = lhs.shape
    ct = ct.astype(lhs.dtype).reshape(m // TILE, TILE, -1)
    w = _tile_weights(rhs, group_sizes, m)
    dlhs = jnp.einsum("tmn,tkn->tmk", ct, w,
                      preferred_element_type=jnp.float32).reshape(m, k)
    dw_tiles = jnp.einsum("tmk,tmn->tkn", lhs.reshape(m // TILE, TILE, k), ct,
                          preferred_element_type=jnp.float32)
    drhs = jax.ops.segment_sum(
        dw_tiles, group_ids_from_sizes(group_sizes, m, TILE),
        num_segments=rhs.shape[0])
    return (dlhs.astype(lhs.dtype), drhs.astype(rhs.dtype),
            np.zeros(group_sizes.shape, jax.dtypes.float0))


_tiled_backend.defvjp(_tiled_fwd, _tiled_bwd)


def grouped_matmul(
    lhs: jnp.ndarray,
    rhs: jnp.ndarray,
    group_sizes: jnp.ndarray,
    backend: str | None = None,
) -> jnp.ndarray:
    """out[i] = lhs[i] @ rhs[group_of(i)] with consecutive groups.

    Rows beyond ``sum(group_sizes)`` (if any) are zeroed by construction at
    the call sites (padding edges carry a zero norm coefficient), so their
    value here is irrelevant.
    """
    if backend in (None, "tiled"):
        return _tiled_backend(lhs, rhs, group_sizes)
    if backend == "gather":
        return _gather_backend(lhs, rhs, group_sizes)
    raise ValueError(f"unknown grouped_matmul backend: {backend}")
