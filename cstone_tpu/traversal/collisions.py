"""Halo discovery via 3D collision detection.

JAX re-design of the reference's findHalos (reference:
include/cstone/traversal/collisions.hpp + collisions_gpu.cu). Every local
leaf builds a halo search box (its node box dilated by the per-leaf
interaction radius); one batched traversal marks all tree leaves whose
boxes collide with any of the local halo boxes, excluding leaves inside
the local assignment.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..sfc.box import Box, IBox
from ..sfc.encode import HILBERT, sfc_ibox
from ..sfc.keys import max_tree_level, node_range, tree_level
from ..tree.octree import LinkedOctree, node_keys_and_levels
from .boxoverlap import contained_in_keys, make_halo_box, overlap_iboxes
from .traversal import batched_mark

__all__ = ["find_halos", "node_iboxes"]


def node_iboxes(tree: LinkedOctree, curve: str = HILBERT) -> IBox:
    """Integer coordinate boxes of every (sorted) octree node."""
    start, _, level = node_keys_and_levels(tree)
    return sfc_ibox(start, level, curve)


def find_halos(
    tree: LinkedOctree,
    interaction_radii: jax.Array,
    box: Box,
    first_node,
    last_node,
    curve: str = HILBERT,
    node_boxes: IBox | None = None,
) -> jax.Array:
    """Mark halo leaf cells (collisions.hpp:59-105).

    interaction_radii: (cap_leaf,) per-leaf halo search radius (typically
        2 * max(h) * searchExtFactor, see halos/halos.hpp:128-160).
    [first_node, last_node): local leaf range (the assignment).
    Returns halo flags over cornerstone leaf indices, (cap_leaf,) int32;
    flags inside the assignment are always 0.
    """
    dt = tree.leaves.dtype
    cap_leaf = tree.leaves.shape[0] - 1
    leaves = tree.leaves

    lowest = leaves[first_node]
    highest = leaves[last_node]

    # per-query halo boxes from the local leaves
    key = leaves[:-1]
    rng = leaves[1:] - key
    safe_rng = jnp.where(rng > 0, rng, node_range(dt, max_tree_level(dt)))
    level = tree_level(safe_rng)
    leaf_ibox = sfc_ibox(key, level, curve)
    halo_box = make_halo_box(leaf_ibox, interaction_radii, box, dt)

    q = jnp.arange(cap_leaf, dtype=jnp.int32)
    in_assignment = (q >= first_node) & (q < last_node)
    # skip leaves whose halo box stays inside the assignment
    inside = contained_in_keys(halo_box, lowest, highest, dt, curve)
    active = in_assignment & (~inside)

    if node_boxes is None:
        node_boxes = node_iboxes(tree, curve)
    node_start, node_end, _ = node_keys_and_levels(tree)

    def gather_ibox(b: IBox, ids) -> IBox:
        return IBox(
            b.xmin[ids], b.xmax[ids], b.ymin[ids], b.ymax[ids], b.zmin[ids], b.zmax[ids]
        )

    def criterion(q_ids, node_ids):
        src = gather_ibox(node_boxes, node_ids)
        tgt = gather_ibox(halo_box, q_ids)
        contained = (node_start[node_ids] >= lowest) & (node_end[node_ids] <= highest)
        return (~contained) & overlap_iboxes(src, tgt, dt)

    marks = batched_mark(
        tree.child_offsets,
        criterion,
        cap_leaf,
        mark_endpoints_only=True,
        active_mask=active,
    )

    # convert node marks -> cornerstone leaf flags
    leaf_pos = tree.leaf_order()
    flags = marks[leaf_pos]
    valid_leaf = q < tree.n_leaf
    return jnp.where(valid_leaf, flags, 0).astype(jnp.int32)
