"""Deterministic stream compaction and lane sorting.

The reference's wavefront queues are atomicAdd ticket counters into index
buffers (device_programs.cu:268-273, 538-541, 752-755) with an in/out pointer
swap per bounce (OptixBackend.cpp:1799-1802) — non-deterministic ordering by
construction.  The equivalents here are scan-based and deterministic
(SURVEY.md §2 "queue compaction"): an exclusive cumsum assigns each live lane
its output slot; a scatter (or gather of the inverse permutation) builds the
queue.  The whole class of queue races disappears (SURVEY.md §5 race note).

These ops are fixed-shape: the "queue" is always N lanes long with a live
count, padding gathered from a sentinel lane.  Downstream stages mask on
`arange(N) < count`.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def compact_indices(mask: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Indices of live lanes, packed to the front.

    Returns (queue (N,) int32, count ()): queue[:count] are the indices where
    `mask` is True in ascending order; queue[count:] point at lane 0 (inert
    padding).  This is the atomicAdd ticket loop made deterministic.
    """
    n = mask.shape[0]
    mask_i = mask.astype(jnp.int32)
    slots = jnp.cumsum(mask_i) - mask_i          # exclusive scan: output slot
    count = jnp.sum(mask_i)
    lane_ids = jnp.arange(n, dtype=jnp.int32)
    # Live lanes scatter to their slot; dead lanes target index n, which
    # mode="drop" discards — the branch-free equivalent of "don't enqueue".
    target = jnp.where(mask, slots, n)
    queue = jnp.zeros((n,), jnp.int32).at[target].set(lane_ids, mode="drop")
    return queue, count


def compact_gather(tree, queue: jnp.ndarray):
    """Gather a PathState-like pytree of (N,) / (N, k) leaves into queue order."""
    import jax

    return jax.tree.map(lambda leaf: leaf[queue], tree)


def scatter_back(tree_compacted, queue: jnp.ndarray, tree_original, mask_count):
    """Inverse of compact_gather: write the first `mask_count` compacted lanes
    back to their home slots, leaving other lanes untouched."""
    import jax

    n = queue.shape[0]
    # Padding slots (>= count) redirect to OOB index n and are dropped, so
    # they can never clobber a live lane (queue padding points at lane 0).
    target = jnp.where(jnp.arange(n) < mask_count, queue, n)

    def put(dst, src):
        return dst.at[target].set(src, mode="drop")

    return jax.tree.map(put, tree_original, tree_compacted)


def sort_by_key(key: jnp.ndarray, *arrays):
    """Stable ascending sort of lane arrays by an int key — the shading-
    coherence transform (sort live lanes by material type so masked branch
    math wastes the fewest lanes; the material-sorted wavefronts of GPU
    folklore)."""
    order = jnp.argsort(key, stable=True)
    return (order,) + tuple(a[order] for a in arrays)


def live_count(mask: jnp.ndarray) -> jnp.ndarray:
    """Number of live lanes (the queue counter readback, without the
    readback: OptixBackend.cpp:1677-1695)."""
    return jnp.sum(mask.astype(jnp.int32))
