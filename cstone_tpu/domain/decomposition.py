"""SFC domain decomposition: assignment of key ranges to ranks.

JAX re-design of the reference's decomposition (reference:
include/cstone/domain/domaindecomp.hpp). A "rank" is a position along the
device-mesh axis; the assignment (one key boundary per rank) is replicated
on every device, exactly like the reference's SfcAssignment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.primitives import cumsum64
from ..ops.primitives import searchsorted as _searchsorted
from ..sfc.keys import enclosing_box_code, max_tree_level, node_range

__all__ = [
    "SfcAssignment",
    "uniform_bins",
    "make_sfc_assignment",
    "find_rank",
    "limit_boundary_shifts",
    "create_send_offsets",
    "translate_assignment",
    "initial_domain_splits",
]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SfcAssignment:
    """Which part of the SFC belongs to which rank (domaindecomp.hpp:73-113).

    boundaries: (n_ranks+1,) keys; rank r owns [boundaries[r], boundaries[r+1]).
    counts:     (n_ranks,) int64 global particle count per rank.
    """

    boundaries: jax.Array
    counts: jax.Array

    @property
    def n_ranks(self) -> int:
        return self.boundaries.shape[0] - 1


def uniform_bins(counts: jax.Array, n_nodes, n_bins: int) -> Tuple[jax.Array, jax.Array]:
    """Histogram bins with uniform element count (domaindecomp.hpp:48-71).

    counts: (cap,) per-node particle counts (padding must be 0).
    Returns (bins (n_bins+1,) int32 node indices, bin_counts (n_bins,) int64).
    """
    scan = jnp.concatenate(
        [jnp.zeros((1,), jnp.int64), cumsum64(counts.astype(jnp.int64))]
    )
    total = scan[jnp.asarray(n_nodes, jnp.int32)]

    # integer split points (the reference uses double, domaindecomp.hpp:56-64;
    # exact integer math, no float rounding in the split points)
    i = jnp.arange(1, n_bins, dtype=jnp.int64)
    targets = (i * total) // n_bins
    mids = jnp.searchsorted(scan, targets, side="left").astype(jnp.int32)
    mids = jnp.minimum(mids, jnp.asarray(n_nodes, jnp.int32))
    bins = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), mids, jnp.asarray(n_nodes, jnp.int32)[None]]
    )
    bin_counts = scan[bins[1:]] - scan[bins[:-1]]
    return bins, bin_counts


def make_sfc_assignment(tree_keys: jax.Array, counts: jax.Array, n_nodes,
                        n_ranks: int) -> SfcAssignment:
    """Equal-count SFC split over the global tree (domaindecomp.hpp:115-124)."""
    bins, bin_counts = uniform_bins(counts, n_nodes, n_ranks)
    boundaries = tree_keys[bins]
    return SfcAssignment(boundaries=boundaries, counts=bin_counts)


def find_rank(assignment: SfcAssignment, keys: jax.Array) -> jax.Array:
    """Owning rank per key: upper_bound - 1 (domaindecomp.hpp:104-108)."""
    r = jnp.searchsorted(assignment.boundaries, keys, side="right").astype(jnp.int32) - 1
    return jnp.clip(r, 0, assignment.n_ranks - 1)


def limit_boundary_shifts(
    old: SfcAssignment, new: SfcAssignment, tree_keys: jax.Array, counts: jax.Array
) -> SfcAssignment:
    """Allow boundaries to move only into the neighbor rank's old range
    (domaindecomp.hpp:126-166); recounts after clamping."""
    n_ranks = new.n_ranks
    b = new.boundaries
    inner = jnp.clip(b[1:-1], old.boundaries[:-2], old.boundaries[2:])
    boundaries = jnp.concatenate([b[:1], inner, b[-1:]])

    # recount per rank
    scan = jnp.concatenate(
        [jnp.zeros((1,), jnp.int64), cumsum64(counts.astype(jnp.int64))]
    )
    pos = _searchsorted(tree_keys, boundaries, side="left").astype(jnp.int32)
    new_counts = scan[pos[1:]] - scan[pos[:-1]]
    return SfcAssignment(boundaries=boundaries, counts=new_counts)


def create_send_offsets(assignment: SfcAssignment, particle_keys: jax.Array,
                        n_particles=None) -> jax.Array:
    """Particle index offsets per destination rank (domaindecomp.hpp:208-230).

    Returns (n_ranks+1,) offsets into the sorted local particle key array.
    """
    offs = _searchsorted(particle_keys, assignment.boundaries, side="left")
    if n_particles is not None:
        offs = jnp.minimum(offs, jnp.asarray(n_particles, offs.dtype))
    return offs


def translate_assignment(
    assignment: SfcAssignment,
    focus_leaves: jax.Array,
    n_focus: jax.Array,
    peer_mask: jax.Array,
    my_rank,
) -> Tuple[jax.Array, jax.Array]:
    """Per-rank (start, end) focus-tree node index ranges for peers + self
    (domaindecomp.hpp:168-206). Non-peer ranks get (0, 0)."""
    b = assignment.boundaries
    # findNodeAbove / findNodeBelow against the focus tree
    starts = jnp.searchsorted(focus_leaves, b[:-1], side="left").astype(jnp.int32)
    ends = (jnp.searchsorted(focus_leaves, b[1:], side="right").astype(jnp.int32) - 1)
    starts = jnp.minimum(starts, n_focus)
    ends = jnp.clip(ends, starts, n_focus)

    n_ranks = assignment.n_ranks
    r = jnp.arange(n_ranks, dtype=jnp.int32)
    keep = (peer_mask.astype(bool)) | (r == my_rank)
    starts = jnp.where(keep, starts, 0)
    ends = jnp.where(keep, ends, 0)
    return starts, ends


def initial_domain_splits(n_ranks: int, level: int, key_dtype) -> np.ndarray:
    """Equal-length SFC segments for the first decomposition
    (domaindecomp.hpp:232-255)."""
    dt = np.dtype(key_dtype)
    total = np.uint64(1) << np.uint64(3 * max_tree_level(dt))
    delta = total // np.uint64(n_ranks)
    mask = ~((np.uint64(1) << np.uint64(3 * (max_tree_level(dt) - level))) - np.uint64(1))
    ret = np.zeros(n_ranks + 1, dtype=dt)
    for i in range(1, n_ranks):
        ret[i] = dt.type((np.uint64(i) * delta) & mask)
    ret[n_ranks] = dt.type(total)
    return ret
