"""Peer-rank discovery via MAC-based tree traversal.

JAX re-design of findPeersMac (reference:
include/cstone/traversal/peers.hpp). Semantics follow the single-traversal
variant findPeersMacStt (peers.hpp:119-171), which the reference validates
as equal to the dual-traversal version: every local leaf traverses the
global tree and marks leaves outside the local assignment that fail the
commutative min+vec MAC; marked leaves map to their owning ranks. The
commutative MAC guarantees mutuality (A sees B <=> B sees A).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..domain.decomposition import SfcAssignment, find_rank
from ..sfc.box import Box, center_and_size
from ..sfc.encode import HILBERT
from ..tree.octree import LinkedOctree, node_keys_and_levels
from .geometry import node_geometry
from .macs import min_vec_mac_mutual
from .traversal import batched_mark

__all__ = ["find_peers_mac", "find_peers_mac_dual"]


def find_peers_mac(
    my_rank,
    assignment: SfcAssignment,
    tree: LinkedOctree,
    box: Box,
    inv_theta_eff: float,
    curve: str = HILBERT,
) -> jax.Array:
    """Peer mask over ranks (peers.hpp:40-117).

    Returns (n_ranks,) int32; 1 marks ranks owning leaves that fail the MAC
    against any leaf in my_rank's assignment. my_rank itself is 0.
    """
    dt = tree.prefixes.dtype
    cap_leaf = tree.leaves.shape[0] - 1
    leaves = tree.leaves

    domain_start = assignment.boundaries[my_rank]
    domain_end = assignment.boundaries[jnp.asarray(my_rank, jnp.int32) + 1]

    first = jnp.searchsorted(leaves, domain_start, side="left").astype(jnp.int32)
    last = jnp.searchsorted(leaves, domain_end, side="left").astype(jnp.int32)

    # target (local leaf) geometry
    from ..sfc.encode import sfc_ibox
    from ..sfc.keys import max_tree_level, node_range, tree_level

    key = leaves[:-1]
    rng = leaves[1:] - key
    safe = jnp.where(rng > 0, rng, node_range(dt, max_tree_level(dt)))
    level = tree_level(safe)
    t_ibox = sfc_ibox(key, level, curve)
    t_center, t_size = center_and_size(t_ibox, box, dt)

    q = jnp.arange(cap_leaf, dtype=jnp.int32)
    active = (q >= first) & (q < last)

    node_start, node_end, _ = node_keys_and_levels(tree)
    n_center, n_size = node_geometry(tree, box, curve)

    def criterion(q_ids, node_ids):
        contained = (node_start[node_ids] >= domain_start) & (node_end[node_ids] <= domain_end)
        mac_pass = min_vec_mac_mutual(
            t_center[q_ids], t_size[q_ids], n_center[node_ids], n_size[node_ids],
            box, inv_theta_eff,
        )
        return (~contained) & (~mac_pass)

    marks = batched_mark(
        tree.child_offsets, criterion, cap_leaf, mark_endpoints_only=True,
        active_mask=active,
    )

    # map marked leaves -> ranks
    cap_nodes = tree.prefixes.shape[0]
    node_ids = jnp.arange(cap_nodes, dtype=jnp.int32)
    is_marked_leaf = (marks > 0) & (tree.child_offsets == 0) & (node_ids < tree.n_nodes)
    ranks = find_rank(assignment, node_start)
    peer_mask = jnp.zeros((assignment.n_ranks,), dtype=jnp.int32)
    peer_mask = peer_mask.at[jnp.where(is_marked_leaf, ranks, assignment.n_ranks)].max(
        1, mode="drop"
    )
    peer_mask = peer_mask.at[jnp.asarray(my_rank, jnp.int32)].set(0)
    return peer_mask


def find_peers_mac_dual(
    my_rank,
    assignment: SfcAssignment,
    tree: LinkedOctree,
    box: Box,
    inv_theta_eff: float,
    curve: str = HILBERT,
    pair_cap: int = 8192,
) -> jax.Array:
    """Dual-traversal peer discovery (the reference's production form,
    peers.hpp:63-117): walk the global tree against itself from the root
    pair, descending only into pairs that fail the commutative MAC, and
    collect close leaf pairs. Ranks owning the non-local side of a close
    pair whose local side lies in my assignment are peers. Equivalent to
    find_peers_mac (the STT form) — the reference asserts the same.

    Returns (peer_mask (n_ranks,) int32, overflow) — overflow > 0 means
    pair_cap was too small and the mask is incomplete.
    """
    from .traversal import dual_traversal

    dt = tree.prefixes.dtype
    domain_start = assignment.boundaries[my_rank]
    domain_end = assignment.boundaries[jnp.asarray(my_rank, jnp.int32) + 1]

    node_start, node_end, levels = node_keys_and_levels(tree)
    n_center, n_size = node_geometry(tree, box, curve)

    def close_fn(a_ids, b_ids):
        # prune pairs that cannot contribute: the local side must overlap
        # my assignment, the remote side must not be fully inside it
        a_overlaps = (node_start[a_ids] < domain_end) & (
            node_end[a_ids] > domain_start
        )
        b_outside = ~(
            (node_start[b_ids] >= domain_start) & (node_end[b_ids] <= domain_end)
        )
        mac_pass = min_vec_mac_mutual(
            n_center[a_ids], n_size[a_ids], n_center[b_ids], n_size[b_ids],
            box, inv_theta_eff,
        )
        return a_overlaps & b_outside & (~mac_pass)

    out_a, out_b, n_out, overflow = dual_traversal(
        tree.child_offsets, levels, close_fn, pair_cap
    )

    # close leaf pairs: local side fully counts (leaf overlap is enough —
    # a leaf overlapping the assignment boundary contributes both ways,
    # and the STT form marks from every local leaf)
    valid = out_b >= 0
    b_safe = jnp.maximum(out_b, 0)
    ranks = find_rank(assignment, node_start[b_safe])
    peer_mask = jnp.zeros((assignment.n_ranks,), dtype=jnp.int32)
    peer_mask = peer_mask.at[
        jnp.where(valid, ranks, assignment.n_ranks)
    ].max(1, mode="drop")
    peer_mask = peer_mask.at[jnp.asarray(my_rank, jnp.int32)].set(0)
    return peer_mask, overflow
