"""Generic batched octree walks.

JAX re-design of the reference's stack-based traversals (reference:
include/cstone/traversal/traversal.hpp:69-110). Instead of one sequential
DFS per thread, all N queries march in lockstep through their own explicit
stacks inside a single `lax.while_loop`; each iteration pops one node per
query and tests its 8 children as a vectorized batch. Queries that finish
early are masked out. This is the traversal shape used for neighbor-search
candidate collection, halo discovery, and MAC marking.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "batched_collect_leaves",
    "dual_traversal",
    "batched_collect_leaves_bfs",
    "batched_mark",
    "STACK_DEPTH",
]

STACK_DEPTH = 128  # same bound as the reference (traversal.hpp:81)


def batched_collect_leaves(
    child_offsets: jax.Array,
    criterion: Callable[[jax.Array, jax.Array], jax.Array],
    n_queries: int,
    out_cap: int,
    stack_depth: int = STACK_DEPTH,
    active_mask: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array]:
    """Collect, per query, the leaf nodes passing `criterion`.

    child_offsets: (cap_nodes,) linked-octree child offsets (0 = leaf).
    criterion(query_ids (M,), node_ids (M,)) -> (M,) bool: whether to
        descend into / accept the node. Must be pure and vectorized.
    n_queries: static query count.
    out_cap: static max collected leaves per query.
    active_mask: optional (n_queries,) bool; inactive queries collect nothing.

    Returns (leaves (n_queries, out_cap) int32 node indices padded with -1,
             counts (n_queries,) int32 — may exceed out_cap to signal
             overflow, extra entries are dropped).
    """
    cap_nodes = child_offsets.shape[0]
    q_ids = jnp.arange(n_queries, dtype=jnp.int32)

    root_pass = criterion(q_ids, jnp.zeros((n_queries,), jnp.int32))
    if active_mask is not None:
        root_pass = root_pass & active_mask
    root_is_leaf = child_offsets[0] == 0

    out = jnp.full((n_queries, out_cap), -1, dtype=jnp.int32)
    # root == endpoint case
    out = out.at[:, 0].set(jnp.where(root_pass & root_is_leaf, 0, -1))
    out_n = jnp.where(root_pass & root_is_leaf, 1, 0).astype(jnp.int32)

    stack = jnp.zeros((n_queries, stack_depth), dtype=jnp.int32)
    stack_pos = jnp.where(root_pass & (~root_is_leaf), 1, 0).astype(jnp.int32)

    def cond(state):
        _, stack_pos, _, _ = state
        return jnp.any(stack_pos > 0)

    def body(state):
        stack, stack_pos, out, out_n = state
        active = stack_pos > 0
        top = jnp.maximum(stack_pos - 1, 0)
        node = stack[q_ids, top]
        node = jnp.where(active, node, 0)
        stack_pos = jnp.where(active, stack_pos - 1, stack_pos)

        # examine 8 children of each popped node
        child0 = child_offsets[node]
        children = child0[:, None] + jnp.arange(8, dtype=jnp.int32)[None, :]
        children_c = jnp.minimum(children, cap_nodes - 1)

        qq = jnp.broadcast_to(q_ids[:, None], (n_queries, 8)).reshape(-1)
        cc = children_c.reshape(-1)
        passed = criterion(qq, cc).reshape(n_queries, 8)
        passed = passed & active[:, None]

        is_leaf = child_offsets[children_c] == 0
        emit = passed & is_leaf
        push = passed & (~is_leaf)

        # ranks within the 8-wide axis
        emit_rank = jnp.cumsum(emit, axis=1) - emit.astype(jnp.int32)
        push_rank = jnp.cumsum(push, axis=1) - push.astype(jnp.int32)

        # scatter emits into out
        slot = out_n[:, None] + emit_rank
        flat_q = jnp.broadcast_to(q_ids[:, None], (n_queries, 8))
        slot_ok = emit & (slot < out_cap)
        out = out.at[
            jnp.where(slot_ok, flat_q, n_queries),
            jnp.where(slot_ok, slot, 0),
        ].set(children_c, mode="drop")
        out_n = out_n + jnp.sum(emit, axis=1, dtype=jnp.int32)

        # scatter pushes onto stack
        spos = stack_pos[:, None] + push_rank
        push_ok = push & (spos < stack_depth)
        stack = stack.at[
            jnp.where(push_ok, flat_q, n_queries),
            jnp.where(push_ok, spos, 0),
        ].set(children_c, mode="drop")
        stack_pos = stack_pos + jnp.sum(push, axis=1, dtype=jnp.int32)
        stack_pos = jnp.minimum(stack_pos, stack_depth)

        return stack, stack_pos, out, out_n

    _, _, out, out_n = jax.lax.while_loop(cond, body, (stack, stack_pos, out, out_n))
    return out, out_n


def batched_collect_leaves_bfs(
    child_offsets: jax.Array,
    criterion: Callable[[jax.Array, jax.Array], jax.Array],
    n_queries: int,
    out_cap: int,
    frontier_cap: int = 64,
    active_mask: jax.Array | None = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Level-synchronous variant of batched_collect_leaves.

    Instead of popping ONE node per query per iteration (max-total-pops
    iterations of mostly-masked work), each iteration expands every query's
    whole frontier of passed internal nodes at once — the loop runs
    tree-depth times (~7), each a dense (n_queries, frontier_cap*8)
    criterion evaluation. Same endpoint set as the DFS walk (reference
    traversal/traversal.hpp:69-110); emission order differs (level-major),
    so callers that need SFC order must sort.

    Returns (leaves (n_queries, out_cap) int32 padded -1,
             counts (n_queries,) int32 — may exceed out_cap on overflow,
             frontier_counts (n_queries,) int32 — max frontier size seen;
             values > frontier_cap mean nodes were DROPPED: results are
             incomplete and the caller must retry with a larger cap).
    """
    cap_nodes = child_offsets.shape[0]
    F = frontier_cap
    q_ids = jnp.arange(n_queries, dtype=jnp.int32)

    root_pass = criterion(q_ids, jnp.zeros((n_queries,), jnp.int32))
    if active_mask is not None:
        root_pass = root_pass & active_mask
    root_is_leaf = child_offsets[0] == 0

    out = jnp.full((n_queries, out_cap), -1, dtype=jnp.int32)
    out = out.at[:, 0].set(jnp.where(root_pass & root_is_leaf, 0, -1))
    out_n = jnp.where(root_pass & root_is_leaf, 1, 0).astype(jnp.int32)

    frontier = jnp.zeros((n_queries, F), dtype=jnp.int32)
    fcnt = jnp.where(root_pass & (~root_is_leaf), 1, 0).astype(jnp.int32)
    fmax = fcnt

    k8 = jnp.arange(8, dtype=jnp.int32)
    slot_ids = jnp.arange(F * 8, dtype=jnp.int32)
    rows = jnp.broadcast_to(q_ids[:, None], (n_queries, F * 8))

    def cond(state):
        _, fcnt, _, _, _ = state
        return jnp.any(fcnt > 0)

    def body(state):
        frontier, fcnt, out, out_n, fmax = state
        slot_valid = slot_ids[None, :] < (fcnt[:, None] * 8)
        child0 = child_offsets[frontier]  # (nq, F)
        children = (child0[:, :, None] + k8[None, None, :]).reshape(n_queries, F * 8)
        cc = jnp.clip(children, 0, cap_nodes - 1)

        passed = criterion(rows.reshape(-1), cc.reshape(-1)).reshape(n_queries, F * 8)
        passed = passed & slot_valid
        is_leaf = child_offsets[cc] == 0
        emit = passed & is_leaf
        push = passed & (~is_leaf)

        emit_rank = jnp.cumsum(emit, axis=1) - emit.astype(jnp.int32)
        slot = out_n[:, None] + emit_rank
        ok = emit & (slot < out_cap)
        out = out.at[
            jnp.where(ok, rows, n_queries), jnp.where(ok, slot, 0)
        ].set(cc, mode="drop")
        out_n = out_n + jnp.sum(emit, axis=1, dtype=jnp.int32)

        push_rank = jnp.cumsum(push, axis=1) - push.astype(jnp.int32)
        nf = jnp.zeros((n_queries, F), dtype=jnp.int32)
        okp = push & (push_rank < F)
        nf = nf.at[
            jnp.where(okp, rows, n_queries), jnp.where(okp, push_rank, 0)
        ].set(cc, mode="drop")
        nfcnt = jnp.sum(push, axis=1, dtype=jnp.int32)
        fmax = jnp.maximum(fmax, nfcnt)
        nfcnt = jnp.minimum(nfcnt, F)
        return nf, nfcnt, out, out_n, fmax

    _, _, out, out_n, fmax = jax.lax.while_loop(
        cond, body, (frontier, fcnt, out, out_n, fmax)
    )
    return out, out_n, fmax


def batched_mark(
    child_offsets: jax.Array,
    criterion: Callable[[jax.Array, jax.Array], jax.Array],
    n_queries: int,
    mark_endpoints_only: bool,
    stack_depth: int = STACK_DEPTH,
    active_mask: jax.Array | None = None,
) -> jax.Array:
    """OR-combine query traversals into one per-node flag array.

    Used by halo collision detection (flags on leaves passing the criterion,
    reference traversal/collisions.hpp:40-57) and MAC marking (flags on every
    node the traversal descends into, reference traversal/macs.hpp:197-226).

    Returns marks: (cap_nodes,) int32 in {0, 1} over sorted node indices.
    """
    cap_nodes = child_offsets.shape[0]
    q_ids = jnp.arange(n_queries, dtype=jnp.int32)

    root_pass = criterion(q_ids, jnp.zeros((n_queries,), jnp.int32))
    if active_mask is not None:
        root_pass = root_pass & active_mask
    root_is_leaf = child_offsets[0] == 0

    marks = jnp.zeros((cap_nodes,), dtype=jnp.int32)
    mark_root = jnp.any(root_pass & (root_is_leaf | (not mark_endpoints_only)))
    marks = marks.at[0].max(mark_root.astype(jnp.int32))

    stack = jnp.zeros((n_queries, stack_depth), dtype=jnp.int32)
    stack_pos = jnp.where(root_pass & (~root_is_leaf), 1, 0).astype(jnp.int32)

    def cond(state):
        _, stack_pos, _ = state
        return jnp.any(stack_pos > 0)

    def body(state):
        stack, stack_pos, marks = state
        active = stack_pos > 0
        top = jnp.maximum(stack_pos - 1, 0)
        node = jnp.where(active, stack[q_ids, top], 0)
        stack_pos = jnp.where(active, stack_pos - 1, stack_pos)

        child0 = child_offsets[node]
        children = child0[:, None] + jnp.arange(8, dtype=jnp.int32)[None, :]
        children_c = jnp.minimum(children, cap_nodes - 1)

        qq = jnp.broadcast_to(q_ids[:, None], (n_queries, 8)).reshape(-1)
        cc = children_c.reshape(-1)
        passed = criterion(qq, cc).reshape(n_queries, 8) & active[:, None]

        is_leaf = child_offsets[children_c] == 0
        if mark_endpoints_only:
            to_mark = passed & is_leaf
        else:
            to_mark = passed
        push = passed & (~is_leaf)

        marks = marks.at[jnp.where(to_mark, children_c, cap_nodes)].max(1, mode="drop")

        push_rank = jnp.cumsum(push, axis=1) - push.astype(jnp.int32)
        spos = stack_pos[:, None] + push_rank
        push_ok = push & (spos < stack_depth)
        flat_q = jnp.broadcast_to(q_ids[:, None], (n_queries, 8))
        stack = stack.at[
            jnp.where(push_ok, flat_q, n_queries),
            jnp.where(push_ok, spos, 0),
        ].set(children_c, mode="drop")
        stack_pos = jnp.minimum(stack_pos + jnp.sum(push, axis=1, dtype=jnp.int32), stack_depth)

        return stack, stack_pos, marks

    _, _, marks = jax.lax.while_loop(cond, body, (stack, stack_pos, marks))
    return marks


def dual_traversal(
    child_offsets: jax.Array,
    levels: jax.Array,
    close_fn: Callable[[jax.Array, jax.Array], jax.Array],
    pair_cap: int,
    roots: Tuple[int, int] = (0, 0),
    max_iters: int = 48,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Simultaneous pair traversal (reference traversal.hpp:136-188).

    Walks pairs (a, b) of tree nodes: pairs where `close_fn` is False are
    dropped (the reference's M2L/far endpoint), close pairs of two leaves
    are emitted (the P2P endpoint), and otherwise the COARSER node is
    split into its 8 children (ties split `a`; a leaf forces splitting
    the other node) — the same descent rule as the reference. JAX
    formulation: a level-synchronous frontier of pairs expanded 8-wide
    per iteration, compacted with a sort (no scatters in the loop).

    child_offsets/levels: (cap_nodes,) linked-octree arrays (0 = leaf).
    close_fn(a_ids (M,), b_ids (M,)) -> (M,) bool, pure and vectorized.
    pair_cap: static frontier AND output capacity.

    Returns (out_a (pair_cap,), out_b, n_out, overflow) — the close leaf
    pairs, padded with -1; overflow > 0 means a frontier or the output
    exceeded pair_cap and the result is incomplete.
    """
    cap_nodes = child_offsets.shape[0]
    k8 = jnp.arange(8, dtype=jnp.int32)

    fa = jnp.zeros((pair_cap,), jnp.int32).at[0].set(jnp.int32(roots[0]))
    fb = jnp.zeros((pair_cap,), jnp.int32).at[0].set(jnp.int32(roots[1]))
    n_f = jnp.int32(1)
    out_a = jnp.full((pair_cap,), -1, jnp.int32)
    out_b = jnp.full((pair_cap,), -1, jnp.int32)
    n_out = jnp.int32(0)
    overflow = jnp.int32(0)

    slot = jnp.arange(pair_cap, dtype=jnp.int32)

    def cond(state):
        _, _, n_f, _, _, _, _, it = state
        return (n_f > 0) & (it < max_iters)

    def body(state):
        fa, fb, n_f, out_a, out_b, n_out, overflow, it = state
        active = slot < n_f
        a = jnp.where(active, fa, 0)
        b = jnp.where(active, fb, 0)

        close = close_fn(a, b) & active
        leaf_a = child_offsets[a] == 0
        leaf_b = child_offsets[b] == 0
        endpoint = close & leaf_a & leaf_b
        descend = close & (~endpoint)
        # split the coarser node; a leaf forces the other side
        split_a = descend & (~leaf_a) & (leaf_b | (levels[a] <= levels[b]))
        split_b = descend & (~split_a)

        # ---- emit endpoints (compact via sort, then append) -------------
        ek = jnp.where(endpoint, jnp.int32(0), jnp.int32(1))
        ek, ea, eb = jax.lax.sort((ek, a, b), num_keys=1, is_stable=False)
        m = jnp.sum(endpoint, dtype=jnp.int32)
        dst = jnp.where(slot < m, n_out + slot, pair_cap)
        out_a = out_a.at[dst].set(ea, mode="drop")
        out_b = out_b.at[dst].set(eb, mode="drop")
        n_out_new = n_out + m
        overflow = jnp.maximum(
            overflow, jnp.where(n_out_new > pair_cap, n_out_new, jnp.int32(0))
        )
        n_out = jnp.minimum(n_out_new, jnp.int32(pair_cap))

        # ---- expand the frontier 8-wide ----------------------------------
        ca = jnp.minimum(child_offsets[a], cap_nodes - 8)
        cb = jnp.minimum(child_offsets[b], cap_nodes - 8)
        na = jnp.where(split_a[:, None], ca[:, None] + k8[None, :], a[:, None])
        nb = jnp.where(split_a[:, None], b[:, None], cb[:, None] + k8[None, :])
        valid = jnp.broadcast_to((split_a | split_b)[:, None], (pair_cap, 8))

        vk = jnp.where(valid, jnp.int32(0), jnp.int32(1)).reshape(-1)
        vk, na_f, nb_f = jax.lax.sort(
            (vk, na.reshape(-1), nb.reshape(-1)), num_keys=1, is_stable=False
        )
        n_new = jnp.sum(valid, dtype=jnp.int32)
        overflow = jnp.maximum(
            overflow, jnp.where(n_new > pair_cap, n_new, jnp.int32(0))
        )
        n_f = jnp.minimum(n_new, jnp.int32(pair_cap))
        return (na_f[:pair_cap], nb_f[:pair_cap], n_f, out_a, out_b, n_out,
                overflow, it + 1)

    fa, fb, n_f, out_a, out_b, n_out, overflow, _ = jax.lax.while_loop(
        cond, body, (fa, fb, n_f, out_a, out_b, n_out, overflow, jnp.int32(0))
    )
    return out_a, out_b, n_out, overflow
