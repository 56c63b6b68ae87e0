"""Mesh-global bounding box and octree build.

JAX equivalents of the reference's MPI-global operations:
  - makeGlobalBox: per-dim min/max + MPI_Allreduce(MIN) with sign flip
    (reference: include/cstone/sfc/box_mpi.hpp:85-119) -> lax.pmin/pmax
  - updateOctreeGlobal: local rebalance+count then MPI_Allreduce(SUM) of
    leaf counts (reference: include/cstone/tree/update_mpi.hpp:48-104)
    -> lax.psum of the count vector inside the fixed-point while_loop.

These functions must be called inside shard_map with `axis_name` bound.
Because the reduced counts are replicated, every rank takes identical
rebalance decisions and the loop needs no extra convergence collective.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sfc.box import Box
from ..tree.csarray import (
    CsArray,
    compute_node_counts,
    root_tree,
    rebalance_decision,
    rebalance_tree,
)

__all__ = ["global_bounds", "compute_global_octree", "update_global_octree"]


def global_bounds(x, y, z, axis_name: str, boundaries=(0, 0, 0),
                  prev_box: Box | None = None) -> Box:
    """Mesh-global coordinate bounding box (box_mpi.hpp:85-119).

    Periodic/fixed dimensions keep the previous box limits; open dimensions
    fit the global particle extent.
    """
    fdt = x.dtype
    mins = jnp.stack([jnp.min(x), jnp.min(y), jnp.min(z)])
    maxs = jnp.stack([jnp.max(x), jnp.max(y), jnp.max(z)])
    gmins = jax.lax.pmin(mins, axis_name)
    gmaxs = jax.lax.pmax(maxs, axis_name)
    if prev_box is not None:
        keep = jnp.asarray([b != 0 for b in prev_box.boundaries])
        gmins = jnp.where(keep, prev_box.mins.astype(fdt), gmins)
        gmaxs = jnp.where(keep, prev_box.maxs.astype(fdt), gmaxs)
        boundaries = prev_box.boundaries
    limits = jnp.stack([gmins[0], gmaxs[0], gmins[1], gmaxs[1], gmins[2], gmaxs[2]])
    return Box(limits=limits, boundaries=tuple(boundaries))


def update_global_octree(
    tree: CsArray, codes: jax.Array, bucket_size, axis_name: str,
    max_count, n_codes=None,
) -> Tuple[CsArray, jax.Array]:
    """One global rebalance+count step (update_mpi.hpp:48-104)."""
    ops, converged = rebalance_decision(tree.keys, tree.counts, tree.n_nodes, bucket_size)
    new_keys, new_n = rebalance_tree(tree.keys, ops, tree.n_nodes)
    local_counts = compute_node_counts(new_keys, codes, max_count, n_codes)
    counts = jax.lax.psum(local_counts, axis_name)
    return CsArray(keys=new_keys, counts=counts, n_nodes=new_n), converged


def compute_global_octree(
    codes: jax.Array,
    bucket_size: int,
    capacity: int,
    axis_name: str,
    n_codes=None,
    max_count=None,
) -> CsArray:
    """Fully converged mesh-global cornerstone tree from local sorted keys.

    Counts are capped at 2^32/numRanks - 1 per rank to avoid overflow in the
    reduction, like the reference (csarray.hpp:419-427).
    """
    if max_count is None:
        # cap: 2^32 / nRanks - 1 to keep the psum below uint32 range
        n_ranks = jax.lax.psum(1, axis_name)
        max_count = (
            jnp.uint64(0xFFFFFFFF) // jnp.asarray(n_ranks, jnp.uint64) - jnp.uint64(1)
        ).astype(jnp.uint32)
    cap_count = max_count

    tree0 = root_tree(codes.dtype, capacity)
    counts0 = jax.lax.psum(
        compute_node_counts(tree0.keys, codes, cap_count, n_codes), axis_name
    )
    tree0 = CsArray(keys=tree0.keys, counts=counts0, n_nodes=tree0.n_nodes)

    def cond(state):
        _, stop = state
        return ~stop

    def body(state):
        tree, _ = state
        tree2, converged = update_global_octree(
            tree, codes, bucket_size, axis_name, cap_count, n_codes
        )
        overflow = tree2.n_nodes > capacity
        return tree2, converged | overflow

    tree, _ = jax.lax.while_loop(cond, body, (tree0, jnp.bool_(False)))
    return tree
