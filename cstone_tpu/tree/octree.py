"""Fully-linked internal octree, built from a cornerstone leaf array.

JAX re-design of the reference's one-pass linked build (reference:
include/cstone/tree/octree.hpp:55-214, octree_gpu.cu). Leaves plus implicit
internal nodes are laid out into one prefix array (Warren-Salmon
placeholder-bit keys), sorted once, and linked with vectorized binary
searches — no iteration over levels during construction.

JAX adaptation: node counts change per step, so every array is padded to a
static capacity; unassigned slots carry an all-ones sentinel prefix that
sorts behind every valid node. All scatters/gathers are batched; the
child-link search runs as one global vectorized searchsorted (the prefix
array is globally sorted, making the reference's per-level search bounds
unnecessary).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.primitives import multi_searchsorted
from ..ops.primitives import searchsorted as _searchsorted
from ..sfc.keys import (
    common_prefix,
    decode_placeholder_bit,
    decode_prefix_length,
    digit_weight,
    encode_placeholder_bit,
    max_tree_level,
    node_range,
    octal_digit,
    tree_level,
)

__all__ = [
    "LinkedOctree",
    "internal_capacity",
    "build_linked_octree",
    "locate_node",
    "containing_node",
    "upsweep",
    "upsweep_sum",
    "node_keys_and_levels",
]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class LinkedOctree:
    """Level/key-sorted octree with parent/child links (octree.hpp:278-375).

    All arrays are capacity-padded; `n_nodes = n_leaf + n_internal` entries
    are valid. Node order: sorted by (level, SFC key) — the root is node 0.

    prefixes:         (cap_nodes,) WS placeholder-bit key per node;
                      padding = all-ones sentinel.
    child_offsets:    (cap_nodes,) index of first child; 0 marks a leaf.
    parents:          (cap_parents,) parent index for each 8-sibling group;
                      parent of node i is parents[(i-1)//8].
    level_range:      (maxLevel+2,) first node index per level.
    internal_to_leaf: (cap_nodes,) cornerstone leaf index per node, negative
                      for internal nodes.
    leaf_to_internal: (cap_nodes,) sorted position per unsorted slot; the
                      leaf part lives at [n_internal : n_internal+n_leaf).
    leaves:           (cap_leaf+1,) the source cornerstone array.
    """

    prefixes: jax.Array
    child_offsets: jax.Array
    parents: jax.Array
    level_range: jax.Array
    internal_to_leaf: jax.Array
    leaf_to_internal: jax.Array
    leaves: jax.Array
    n_leaf: jax.Array
    n_internal: jax.Array

    @property
    def n_nodes(self) -> jax.Array:
        return self.n_leaf + self.n_internal

    @property
    def capacity(self) -> int:
        return self.prefixes.shape[0]

    def leaf_order(self) -> jax.Array:
        """Sorted node index of each cornerstone leaf: (cap_leaf,) gather of
        leaf_to_internal offset by n_internal (octree.hpp:385-389)."""
        cap_leaf = self.leaves.shape[0] - 1
        idx = jnp.arange(cap_leaf, dtype=jnp.int32) + self.n_internal
        idx = jnp.minimum(idx, self.leaf_to_internal.shape[0] - 1)
        return self.leaf_to_internal[idx]


def internal_capacity(cap_leaf: int) -> int:
    """Static bound on internal nodes for cap_leaf leaves: (n-1)/7 rounded up."""
    return (cap_leaf + 6) // 7 + 1


def _binary_key_weight(key: jax.Array, level: jax.Array, lmax: int) -> jax.Array:
    """Offset from leaf index to implicit internal-node slot
    (octree.hpp:72-82)."""
    ret = jnp.zeros(key.shape, dtype=jnp.int32)
    for l in range(1, lmax + 1):
        digit = octal_digit(key, l)
        ret = ret + jnp.where(l <= level + 1, digit_weight(digit), 0)
    return ret


def build_linked_octree(leaves: jax.Array, n_leaf, cap_nodes: int | None = None) -> LinkedOctree:
    """Build the linked octree from a padded cornerstone array
    (octree.hpp:186-214).

    leaves: (cap_leaf+1,) padded cornerstone keys; n_leaf valid nodes.
    """
    dt = leaves.dtype
    lmax = max_tree_level(dt)
    cap_leaf = leaves.shape[0] - 1
    if cap_nodes is None:
        cap_nodes = cap_leaf + internal_capacity(cap_leaf)
    cap_parents = max(1, (cap_nodes - 1) // 8 + 1)

    n_leaf = jnp.asarray(n_leaf, dtype=jnp.int32)
    n_internal = (n_leaf - 1) // 7
    n_nodes = n_leaf + n_internal

    sentinel = dt.type(np.iinfo(dt).max)

    # ---- createUnsortedLayout (octree.hpp:95-118) -------------------------
    tid = jnp.arange(cap_leaf, dtype=jnp.int32)
    key = leaves[:-1]
    rng = leaves[1:] - key
    safe_rng = jnp.where(rng > 0, rng, node_range(dt, lmax))
    level = tree_level(safe_rng)
    leaf_valid = tid < n_leaf

    leaf_prefix = encode_placeholder_bit(key, 3 * level)

    # internal nodes: leaf tid hosts internal node (tid + weight)/7 when its
    # prefix with the next leaf has full-octal length
    plen = common_prefix(key, leaves[1:])
    is_oct = (plen % 3 == 0) & (tid < n_leaf - 1)
    oct_index = (tid + _binary_key_weight(key, (plen // 3).astype(jnp.int32), lmax)) // 7
    internal_prefix = encode_placeholder_bit(key, plen)

    # ---- sort by prefix, build permutations (octree.hpp:196-209) ----------
    # SORT-formulated unsorted layout: instead of scattering leaf/internal
    # prefixes into their unsorted slots (2 scalar scatters of cap_leaf
    # indices) and sorting that, concatenate
    # (prefix, unsorted-slot-id) rows for both node classes and let ONE
    # sort produce prefixes_sorted + the sorted->unsorted permutation
    # directly. Invalid rows carry the sentinel prefix and sort behind all
    # valid nodes; the [:cap_nodes] slice keeps every valid row because
    # n_nodes <= cap_nodes <= 2*cap_leaf.
    prefix_rows = jnp.concatenate([
        jnp.where(leaf_valid, leaf_prefix, sentinel),
        jnp.where(is_oct, internal_prefix, sentinel),
    ])
    id_rows = jnp.concatenate([
        n_internal + tid,  # invalid leaves too: keeps ids unique
        jnp.where(is_oct, oct_index, cap_nodes),
    ])
    prefixes_sorted, perm = jax.lax.sort(
        (prefix_rows, id_rows), num_keys=1, is_stable=False
    )
    prefixes_sorted = prefixes_sorted[:cap_nodes]
    perm = perm[:cap_nodes]
    leaf_to_internal = jnp.zeros((cap_nodes,), dtype=jnp.int32)
    leaf_to_internal = leaf_to_internal.at[perm].set(
        jnp.arange(cap_nodes, dtype=jnp.int32), mode="drop"
    )
    internal_to_leaf = perm - n_internal

    # ---- link children + parents + level ranges (octree.hpp:132-178) -----
    # In placeholder-bit space the first child's prefix is p << 3 and the
    # parent's is p >> 3, so all link queries are shifts of
    # prefixes_sorted and ride ONE merged multi_searchsorted — no
    # decode/encode gathers, no per-link scatters. Membership uses the
    # lower/upper-bound pair (valid prefixes are unique): right - left >= 1.
    i = jnp.arange(cap_nodes, dtype=jnp.int32)
    plen_s = decode_prefix_length(prefixes_sorted)
    can_child = plen_s <= 3 * lmax - 3  # max-level nodes: p<<3 would wrap
    child_q = jnp.where(can_child, prefixes_sorted << dt.type(3), sentinel)

    par_count = (cap_nodes - 1) // 8 + 1
    strided = jax.lax.slice(
        jnp.concatenate([prefixes_sorted,
                         jnp.full((8,), sentinel, dt)]),
        [1], [1 + 8 * par_count], [8],
    )  # prefix of node 8g+1, the first child of each sibling group
    parent_q = strided >> dt.type(3)

    level_starts = jnp.asarray(
        [1 << (3 * l) for l in range(lmax + 1)], dtype=np.uint64
    ).astype(dt)

    child_lo, child_hi, parent_lo, lev_lo = multi_searchsorted(
        prefixes_sorted,
        [child_q, child_q, parent_q, level_starts],
        sides=["left", "right", "left", "left"],
    )

    found = (child_hi - child_lo >= 1) & can_child & (i < n_nodes)
    child_offsets = jnp.where(found, child_lo, 0)
    g = jnp.arange(par_count, dtype=jnp.int32)
    par_valid = (8 * g + 1 < n_nodes) & (strided != sentinel)
    parents = jnp.where(par_valid, parent_lo, 0)
    parents = jnp.concatenate(
        [parents, jnp.zeros((cap_parents - par_count,), jnp.int32)]
    ) if cap_parents > par_count else parents[:cap_parents]

    level_range = jnp.minimum(lev_lo, n_nodes)
    level_range = jnp.concatenate([level_range, n_nodes[None]])

    return LinkedOctree(
        prefixes=prefixes_sorted,
        child_offsets=child_offsets,
        parents=parents,
        level_range=level_range,
        internal_to_leaf=internal_to_leaf,
        leaf_to_internal=leaf_to_internal,
        leaves=leaves,
        n_leaf=n_leaf,
        n_internal=n_internal,
    )


def locate_node(tree: LinkedOctree, node_key: jax.Array) -> jax.Array:
    """Index of the node with the given WS-prefix key, or n_nodes if absent
    (octree.hpp:217-241). Vectorized over node_key."""
    cap = tree.prefixes.shape[0]
    idx = jnp.searchsorted(tree.prefixes, node_key, side="left").astype(jnp.int32)
    hit = (idx < tree.n_nodes) & (tree.prefixes[jnp.minimum(idx, cap - 1)] == node_key)
    return jnp.where(hit, idx, tree.n_nodes)


def containing_node(tree: LinkedOctree, node_key: jax.Array) -> jax.Array:
    """Smallest node containing the WS-prefix key (octree.hpp:244-261).

    Vectorized: walks down from the root with a static loop over levels.
    """
    dt = tree.prefixes.dtype
    lmax = max_tree_level(dt)
    level = (decode_prefix_length(node_key) // 3).astype(jnp.int32)
    key = decode_placeholder_bit(node_key)

    ret = jnp.zeros(node_key.shape, dtype=jnp.int32)
    done = jnp.zeros(node_key.shape, dtype=bool)
    for i in range(1, lmax + 1):
        past = jnp.asarray(i, jnp.int32) > level
        stop = (tree.child_offsets[ret] == 0) | (node_key == tree.prefixes[ret])
        done = done | past | stop
        nxt = tree.child_offsets[ret] + octal_digit(key, i)
        ret = jnp.where(done, ret, nxt)
    return ret


def upsweep(
    tree: LinkedOctree,
    leaf_quantities: jax.Array,
    combine: Callable[[jax.Array, jax.Array], jax.Array],
    init_internal=0,
) -> jax.Array:
    """Bottom-up per-node reduction (octree.hpp:583-602).

    leaf_quantities: (cap_leaf,) per-cornerstone-leaf values. Returns
    (cap_nodes,) per-node values in sorted octree order. `combine(node_idx,
    children_values)` maps (n,) int32 node indices and (n, 8) child values
    to (n,) parent values.
    """
    cap_nodes = tree.prefixes.shape[0]
    cap_leaf = tree.leaves.shape[0] - 1
    tail = leaf_quantities.shape[1:]

    q = jnp.full((cap_nodes,) + tail, init_internal, dtype=leaf_quantities.dtype)
    # scatter leaf values to their sorted positions
    leaf_pos = tree.leaf_order()
    tid = jnp.arange(cap_leaf, dtype=jnp.int32)
    q = q.at[jnp.where(tid < tree.n_leaf, leaf_pos, cap_nodes)].set(
        leaf_quantities, mode="drop"
    )

    # Children of every internal node are 8 consecutive slots, and groups
    # tile [1, n_nodes) exactly — so each level's combine is a STATIC
    # reshape-reduce of q[1:] plus a small scatter to the parents, instead
    # of a (cap_nodes, 8) gather per level.
    n_groups = (cap_nodes - 1) // 8
    gidx = jnp.arange(n_groups, dtype=jnp.int32)
    child0 = 1 + 8 * gidx
    parents = tree.parents[:n_groups].astype(jnp.int32)
    # level of each group's children (groups are level-contiguous)
    child_lvl = (
        jnp.searchsorted(tree.level_range, child0, side="right").astype(jnp.int32)
        - 1
    )
    valid_group = (child0 + 8) <= tree.n_nodes

    lmax = tree.level_range.shape[0] - 2
    for lvl in range(lmax, 0, -1):
        groups_here = valid_group & (child_lvl == lvl)
        ch = q[1 : 1 + 8 * n_groups].reshape((n_groups, 8) + tail)
        combined = combine(parents, ch)  # same (n, 8)+tail layout as before
        q = q.at[jnp.where(groups_here, parents, cap_nodes)].set(
            combined, mode="drop"
        )
    return q


def upsweep_sum(tree: LinkedOctree, leaf_quantities: jax.Array, saturate_u32=False) -> jax.Array:
    """Sum upsweep; optional uint32 saturation for counts
    (octree.hpp:604-626)."""
    if saturate_u32:
        def combine(_, children):
            s = jnp.sum(children.astype(jnp.uint64), axis=-1)
            return jnp.minimum(s, jnp.uint64(0xFFFFFFFF)).astype(leaf_quantities.dtype)
    else:
        def combine(_, children):
            return jnp.sum(children, axis=-1)

    return upsweep(tree, leaf_quantities, combine)


def node_keys_and_levels(tree: LinkedOctree) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Plain (start_key, end_key, level) per sorted node slot."""
    dt = tree.prefixes.dtype
    lmax = max_tree_level(dt)
    valid = jnp.arange(tree.prefixes.shape[0], dtype=jnp.int32) < tree.n_nodes
    safe_prefix = jnp.where(valid, tree.prefixes, dt.type(1))
    start = decode_placeholder_bit(safe_prefix)
    level = (decode_prefix_length(safe_prefix) // 3).astype(jnp.int32)
    end = start + node_range(dt, jnp.minimum(level, lmax))
    return start, end, level
