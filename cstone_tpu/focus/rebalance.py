"""Locally-essential-tree (LET) rebalance decisions.

JAX re-design of the reference's focus rebalance ops (reference:
include/cstone/focus/rebalance.hpp + rebalance_gpu.cu). All decisions are
per-node vectorized; ancestor walks unroll into static maxLevel-step loops
(chains are at most maxLevel long). enforce_keys processes all mandatory
keys in parallel like the reference's GPU path.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.primitives import cumsum64
from ..sfc.keys import (
    decode_placeholder_bit,
    decode_prefix_length,
    last_nz_place,
    make_prefix,
    max_tree_level,
    node_range,
)
from ..tree.octree import LinkedOctree, containing_node

__all__ = [
    "CONVERGED",
    "CANCEL_MERGE",
    "REBALANCE",
    "FAILED",
    "rebalance_decision_essential",
    "mac_refine_decision",
    "protect_ancestors",
    "enforce_keys",
    "range_count",
]

# ResolutionStatus (rebalance.hpp:186-196)
CONVERGED = 0
CANCEL_MERGE = 1
REBALANCE = 2
FAILED = 3


def _node_levels(prefixes: jax.Array) -> jax.Array:
    return (decode_prefix_length(prefixes) // 3).astype(jnp.int32)


def rebalance_decision_essential(
    tree: LinkedOctree,
    counts: jax.Array,
    macs: jax.Array,
    focus_start,
    focus_end,
    bucket_size,
) -> Tuple[jax.Array, jax.Array]:
    """Combined count+MAC split/fuse decision per node
    (rebalance.hpp:42-88, 131-169).

    counts, macs: (cap_nodes,) per-node particle counts and MAC flags.
    Returns (node_ops (cap_nodes,) int32 in {0,1,8}, converged).
    """
    dt = tree.prefixes.dtype
    lmax = max_tree_level(dt)
    cap = tree.prefixes.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < tree.n_nodes

    safe_prefix = jnp.where(valid, tree.prefixes, dt.type(1))
    level = _node_levels(safe_prefix)
    parent = jnp.where(idx > 0, tree.parents[jnp.maximum(idx - 1, 0) // 8], 0)

    count_merge = counts[parent] <= jnp.asarray(bucket_size, counts.dtype)
    mac_merge = macs[parent] == 0

    first_group = decode_placeholder_bit(
        jnp.where(valid, tree.prefixes[parent], dt.type(1))
    )
    last_group = first_group + dt.type(8) * node_range(dt, level)
    in_fringe = (last_group > focus_start) & (focus_end > first_group)

    merge = (idx > 0) & (count_merge | (mac_merge & (~in_fringe)))

    node_start = decode_placeholder_bit(safe_prefix)
    is_leaf = tree.child_offsets == 0
    in_focus = (node_start >= focus_start) & (node_start < focus_end)
    split = (
        is_leaf
        & (level < lmax)
        & (counts > jnp.asarray(bucket_size, counts.dtype))
        & ((macs != 0) | in_focus)
    )

    ops = jnp.where(merge, 0, jnp.where(split, 8, 1)).astype(jnp.int32)
    ops = jnp.where(valid, ops, 1)
    converged = jnp.all(jnp.where(valid & is_leaf, ops == 1, True))
    return ops, converged


def mac_refine_decision(tree: LinkedOctree, macs: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Split leaves whose MAC flag is set (rebalance.hpp:90-97)."""
    dt = tree.prefixes.dtype
    lmax = max_tree_level(dt)
    cap = tree.prefixes.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < tree.n_nodes
    level = _node_levels(jnp.where(valid, tree.prefixes, dt.type(1)))
    is_leaf = tree.child_offsets == 0
    split = is_leaf & (level < lmax) & (macs != 0)
    ops = jnp.where(split, 8, 1).astype(jnp.int32)
    ops = jnp.where(valid, ops, 1)
    converged = jnp.all(jnp.where(valid & is_leaf, ops == 1, True))
    return ops, converged


def protect_ancestors(
    tree: LinkedOctree, node_ops: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Left-most descendants inherit their closest nonzero ancestor's op;
    other descendants of merged subtrees become 0 (rebalance.hpp:99-184).

    Returns (new_ops, converged).
    """
    dt = tree.prefixes.dtype
    cap = tree.prefixes.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < tree.n_nodes
    start = decode_placeholder_bit(jnp.where(valid, tree.prefixes, dt.type(1)))

    # level DOWNSWEEP instead of per-node ancestor chasing: a node's
    # nearest nonzero-op ancestor is itself if its op != 0, else its
    # parent's. Children are 8 consecutive slots tiling [1, n_nodes), so
    # each level is a static slice plus one small parent gather instead of
    # up to maxLevel rounds of full-capacity gathers.
    n_groups = (cap - 1) // 8
    gidx = jnp.arange(n_groups, dtype=jnp.int32)
    child0 = 1 + 8 * gidx
    parents = tree.parents[:n_groups].astype(jnp.int32)
    child_lvl = (
        jnp.searchsorted(tree.level_range, child0, side="right").astype(jnp.int32)
        - 1
    )
    valid_group = (child0 + 8) <= tree.n_nodes

    eff = node_ops.astype(jnp.int32)  # nearest nonzero-op ancestor's op
    anc_start = start  # that ancestor's start key
    own_ops = node_ops[1 : 1 + 8 * n_groups].reshape(n_groups, 8)
    own_start = start[1 : 1 + 8 * n_groups].reshape(n_groups, 8)
    lmax_lr = tree.level_range.shape[0] - 2
    for lvl in range(1, lmax_lr + 1):
        here = valid_group & (child_lvl == lvl)
        p_eff = eff[parents]
        p_astart = anc_start[parents]
        self_anchor = own_ops != 0
        new_eff = jnp.where(self_anchor, own_ops, p_eff[:, None])
        new_astart = jnp.where(self_anchor, own_start, p_astart[:, None])
        cur_eff = eff[1 : 1 + 8 * n_groups].reshape(n_groups, 8)
        cur_astart = anc_start[1 : 1 + 8 * n_groups].reshape(n_groups, 8)
        eff = eff.at[1 : 1 + 8 * n_groups].set(
            jnp.where(here[:, None], new_eff, cur_eff).reshape(-1)
        )
        anc_start = anc_start.at[1 : 1 + 8 * n_groups].set(
            jnp.where(here[:, None], new_astart, cur_astart).reshape(-1)
        )

    same_start = start == anc_start
    new_ops = jnp.where((idx == 0) | same_start, eff, 0).astype(jnp.int32)

    new_ops = jnp.where(valid, new_ops, 0)
    converged = jnp.all(jnp.where(valid, new_ops == 1, True))
    return new_ops, converged


def enforce_keys(
    tree: LinkedOctree, mandatory_keys: jax.Array, node_ops: jax.Array,
    n_keys=None,
) -> Tuple[jax.Array, jax.Array]:
    """Cancel merges / request splits so mandatory keys stay resolvable
    (rebalance.hpp:198-267). All keys processed in parallel, matching the
    reference's GPU path (rebalance_gpu.cu enforceKeysGpu).

    Returns (new_ops, status) with status the max ResolutionStatus over keys.
    """
    dt = tree.prefixes.dtype
    lmax = max_tree_level(dt)
    cap = tree.prefixes.shape[0]
    kk = mandatory_keys.shape[0]

    active = jnp.ones((kk,), dtype=bool)
    if n_keys is not None:
        active = jnp.arange(kk, dtype=jnp.int32) < n_keys
    trivial = (mandatory_keys == 0) | (mandatory_keys == node_range(dt, 0))
    active = active & (~trivial)

    want = make_prefix(mandatory_keys)
    node_idx = containing_node(tree, want)
    have = tree.prefixes[node_idx]
    level_have = _node_levels(have)

    try_split = (have != want) & (level_have < lmax)
    undo = ((node_ops[node_idx] == 0) | try_split) & (node_idx > 0) & active

    # undo merges along the ancestor chain: all siblings of every ancestor
    ops = node_ops
    chain = node_idx
    for _ in range(lmax + 1):
        parent = jnp.where(chain > 0, tree.parents[jnp.maximum(chain - 1, 0) // 8], 0)
        first_sib = tree.child_offsets[parent]
        sib = first_sib[:, None] + jnp.arange(8, dtype=jnp.int32)[None, :]
        do = undo[:, None] & jnp.broadcast_to((chain > 0)[:, None], sib.shape)
        ops = ops.at[jnp.where(do, jnp.minimum(sib, cap - 1), cap)].max(1, mode="drop")
        chain = parent

    # request split toward the key, at most 1 extra level
    key_pos = last_nz_place(mandatory_keys)
    level_diff = key_pos - level_have
    split_req = jnp.int32(1) << (3 * jnp.minimum(level_diff, 1))
    do_split = try_split & active
    ops = ops.at[jnp.where(do_split, node_idx, cap)].max(
        jnp.where(do_split, split_req, 0), mode="drop"
    )

    status_k = jnp.where(
        try_split,
        jnp.where(level_diff > 1, FAILED, REBALANCE),
        jnp.where(undo, CANCEL_MERGE, CONVERGED),
    )
    status = jnp.max(jnp.where(active, status_k, CONVERGED))
    return ops, status


def range_count(
    global_leaves: jax.Array,
    global_counts: jax.Array,
    focus_leaves: jax.Array,
    focus_idx: jax.Array,
    n_idx,
    counts_focus: jax.Array,
) -> jax.Array:
    """Fill focus-leaf counts from the global tree (rebalance.hpp:269-299).

    focus_idx: (cap,) list of focus leaf indices to fill; first n_idx valid.
    Returns updated counts_focus.
    """
    cap = focus_idx.shape[0]
    scan = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint64), cumsum64(global_counts.astype(jnp.uint64))]
    )
    safe_idx = jnp.minimum(focus_idx, focus_leaves.shape[0] - 2)
    start_key = focus_leaves[safe_idx]
    end_key = focus_leaves[safe_idx + 1]
    a = jnp.searchsorted(global_leaves, start_key, side="left")
    b = jnp.searchsorted(global_leaves, end_key, side="left")
    cnt = jnp.minimum(scan[b] - scan[a], jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)

    k = jnp.arange(cap, dtype=jnp.int32)
    do = k < n_idx
    return counts_focus.at[jnp.where(do, safe_idx, counts_focus.shape[0])].set(
        cnt, mode="drop"
    )
