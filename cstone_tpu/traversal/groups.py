"""Target particle grouping for traversal amortization.

JAX equivalent of the reference's target groups (reference:
include/cstone/traversal/groups.hpp:19-55, groups_gpu.{h,cuh}). Groups are
ranges of SFC-consecutive, spatially compact particles that share one tree
traversal. Provides fixed-size grouping (computeFixedGroups,
groups_gpu.h:46-56) and adaptive splitting where the distance between
consecutive particles exceeds a tolerance (computeGroupSplits,
groups_gpu.h:58-75) — both as static-shaped group boundary arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from ..sfc.box import Box, apply_pbc

__all__ = ["GroupData", "fixed_groups", "adaptive_groups"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GroupData:
    """Padded list of target groups (groups.hpp:19-55).

    group_start/group_end: (cap_groups,) particle index ranges; entries
    beyond n_groups repeat the last boundary (empty groups).
    """

    group_start: jax.Array
    group_end: jax.Array
    n_groups: jax.Array


def fixed_groups(first, last, group_size: int, cap_groups: int) -> GroupData:
    """Equally-sized groups over [first, last) (groups_gpu.h:46-56)."""
    first = jnp.asarray(first, jnp.int32)
    last = jnp.asarray(last, jnp.int32)
    n = jnp.maximum(last - first, 0)
    n_groups = (n + group_size - 1) // group_size
    g = jnp.arange(cap_groups, dtype=jnp.int32)
    starts = jnp.minimum(first + g * group_size, last)
    ends = jnp.minimum(starts + group_size, last)
    return GroupData(group_start=starts, group_end=ends, n_groups=n_groups)


def adaptive_groups(
    x: jax.Array,
    y: jax.Array,
    z: jax.Array,
    first,
    last,
    max_group_size: int,
    distance_tol: float,
    box: Box,
    cap_groups: int,
) -> GroupData:
    """Split where consecutive-particle distance exceeds the tolerance or
    the group is full (groups_gpu.h:58-75, groups_gpu.cuh findSplits).

    Returns group boundaries over [first, last).
    """
    n = x.shape[0]
    i = jnp.arange(n, dtype=jnp.int32)
    first = jnp.asarray(first, jnp.int32)
    last = jnp.asarray(last, jnp.int32)

    dX = jnp.stack(
        [x - jnp.roll(x, 1), y - jnp.roll(y, 1), z - jnp.roll(z, 1)], axis=-1
    )
    dX = apply_pbc(dX, box)
    far = jnp.sum(dX * dX, axis=-1) > jnp.asarray(distance_tol, x.dtype) ** 2

    # a split before i if the distance jump is large; force a split at least
    # every max_group_size members since the last split (cumulative max gives
    # each position the start of its current segment)
    in_range = (i >= first) & (i < last)
    is_split = (far & in_range & (i > first)) | (i == first)
    seg_start = jax.lax.cummax(jnp.where(is_split, i, -1))
    is_split = is_split | (
        in_range & (i > first) & ((i - seg_start) % max_group_size == 0)
    )

    # compact split positions into group starts; pad with `last`
    rank = jnp.cumsum(is_split.astype(jnp.int32)) - is_split.astype(jnp.int32)
    starts = jnp.full((cap_groups,), 1, dtype=jnp.int32) * last
    ok = is_split & (rank < cap_groups)
    starts = starts.at[jnp.where(ok, rank, cap_groups)].set(i, mode="drop")
    n_groups = jnp.sum(is_split.astype(jnp.int32))

    ends = jnp.concatenate([starts[1:], last[None]])
    return GroupData(group_start=starts, group_end=ends, n_groups=n_groups)
