"""Cornerstone leaf-array octree build.

Re-design of the reference's core data structure (reference:
include/cstone/tree/csarray.hpp + csarray_gpu.cu). The cornerstone format
is a sorted array of SFC keys containing 0 and 2^(3*maxLevel) whose
consecutive differences are powers of 8; entry i is the start key of leaf
i and the end key of leaf i-1 (csarray.hpp:30-50).

JAX adaptation: the number of tree nodes changes every rebalance step,
which XLA cannot express with dynamic shapes. We carry a capacity-padded
key array plus a node count; the padding tail repeats the terminal key
2^(3*maxLevel), which makes every binary search and count naturally return
zero-width results for padded slots. Split/merge emission is formulated as
a *gather* (each output node looks up its source node through the
exclusive scan of the per-node op codes) instead of the reference's
scatter, which maps better onto XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.primitives import searchsorted as _searchsorted
from ..sfc.keys import (
    log8_ceil,
    max_tree_level,
    node_range,
    octal_digit,
    span_sfc_range,
    span_sfc_range_count,
    tree_level,
)

__all__ = [
    "CsArray",
    "root_tree",
    "find_node_below",
    "find_node_above",
    "compute_node_counts",
    "rebalance_decision",
    "rebalance_tree",
    "update_octree",
    "compute_octree",
    "update_treelet_ops",
    "compute_spanning_tree",
]

MAX_UINT32 = np.uint32(0xFFFFFFFF)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CsArray:
    """Capacity-padded cornerstone octree leaf array.

    keys:    (capacity+1,) uint32/uint64; keys[0..n_nodes] are the node
             boundaries; keys[n_nodes..] == 2^(3*maxLevel) (padding).
    counts:  (capacity,) uint32 particle counts per leaf; padded with 0.
    n_nodes: () int32 number of valid leaf nodes.
    """

    keys: jax.Array
    counts: jax.Array
    n_nodes: jax.Array

    @property
    def capacity(self) -> int:
        return self.keys.shape[0] - 1


def root_tree(key_dtype, capacity: int, n_particles=0) -> CsArray:
    """The single-root tree {0, nodeRange(0)} (csarray.hpp:458)."""
    dt = np.dtype(key_dtype)
    end = np.uint64(1) << np.uint64(3 * max_tree_level(dt))
    keys = jnp.full((capacity + 1,), dt.type(end), dtype=dt)
    keys = keys.at[0].set(dt.type(0))
    counts = jnp.zeros((capacity,), dtype=jnp.uint32)
    counts = counts.at[0].set(jnp.uint32(n_particles))
    return CsArray(keys=keys, counts=counts, n_nodes=jnp.int32(1))


def find_node_below(tree_keys: jax.Array, n_nodes, key) -> jax.Array:
    """First node that starts at or below `key` (csarray.hpp:79-83)."""
    idx = jnp.searchsorted(tree_keys, key, side="right").astype(jnp.int32) - 1
    return jnp.minimum(idx, n_nodes - 1)


def find_node_above(tree_keys: jax.Array, n_nodes, key) -> jax.Array:
    """First node that starts at or above `key` (csarray.hpp:86-90)."""
    del n_nodes
    return jnp.searchsorted(tree_keys, key, side="left").astype(jnp.int32)


def compute_node_counts(
    tree_keys: jax.Array,
    codes: jax.Array,
    max_count=MAX_UINT32,
    n_codes=None,
) -> jax.Array:
    """Particles per leaf via two vectorized binary searches
    (csarray.hpp:187-254).

    codes must be sorted; padded invalid particles must carry keys >=
    2^(3*maxLevel) (e.g. the removeKey sentinel) so they fall outside every
    node. If `n_codes` is given, only codes[:n_codes] are counted (codes
    beyond must sort to the end).
    """
    ends = _searchsorted(codes, tree_keys, side="left").astype(jnp.int64)
    if n_codes is not None:
        ends = jnp.minimum(ends, jnp.asarray(n_codes, dtype=jnp.int64))
    counts = (ends[1:] - ends[:-1]).astype(jnp.uint32)
    return jnp.minimum(counts, jnp.asarray(max_count, dtype=jnp.uint32))


def _shift_up(a: jax.Array, k: int, fill) -> jax.Array:
    """out[i] = a[i + k] with `fill` past the end (k >= 0, static)."""
    if k == 0:
        return a
    return jnp.concatenate([a[k:], jnp.full((k,), fill, a.dtype)])


def _shift_down(a: jax.Array, k: int, fill) -> jax.Array:
    """out[i] = a[i - k] with `fill` before the start (k >= 0, static)."""
    if k == 0:
        return a
    return jnp.concatenate([jnp.full((k,), fill, a.dtype), a[:-k]])


def _select_shift_down(a: jax.Array, k_arr: jax.Array, fill) -> jax.Array:
    """out[i] = a[i - k_arr[i]] for k_arr in [0, 8) — an 8-way static-shift
    select instead of a gather: the 8 shifted copies + selects are
    elementwise passes)."""
    out = jnp.full(a.shape, fill, a.dtype)
    for k in range(8):
        out = jnp.where(k_arr == k, _shift_down(a, k, fill), out)
    return out


def _sibling_and_level(tree_keys: jax.Array, n_nodes) -> Tuple[jax.Array, jax.Array]:
    """Vectorized siblingAndLevel (csarray.hpp:269-283).

    Returns (sibling_idx, level) per node slot; sibling_idx == -1 where the
    8-sibling group is incomplete or level == 0. Gather-free: the group
    start/end key lookups tree_keys[i - sib] and tree_keys[i - sib + 8]
    ride 8-way static-shift selects (sib is in [0, 8)).
    """
    dt = tree_keys.dtype
    cap = tree_keys.shape[0] - 1
    this = tree_keys[:-1]
    rng = tree_keys[1:] - this

    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < n_nodes
    # padded slots have rng == 0; feed a safe power of 8 instead
    safe_rng = jnp.where(valid & (rng > 0), rng, node_range(dt, max_tree_level(dt)))
    level = tree_level(safe_rng)

    sib = octal_digit(this, level)
    end_key = node_range(dt, 0)
    # group-start key tree_keys[i - sib]: shift select (i - sib < 0 can
    # only happen for i < 8 with a malformed prefix; mask those below)
    key_group = _select_shift_down(this, sib, end_key)
    # group-end key tree_keys[i - sib + 8] = value at i + (8 - sib):
    # select over k' = 8 - sib in [1, 8]
    key_group_end = jnp.full(this.shape, end_key, dt)
    for kp in range(1, 9):
        key_group_end = jnp.where(
            sib == 8 - kp, _shift_up(this, kp, end_key), key_group_end
        )
    parent_range = node_range(dt, jnp.maximum(level, 1) - 1)
    siblings_ok = key_group_end == key_group + parent_range
    bad_prefix = sib > idx  # group would start before the array
    sib = jnp.where(siblings_ok & (level > 0) & ~bad_prefix, sib, jnp.int32(-1))
    return sib, level


def rebalance_decision(
    tree_keys: jax.Array, counts: jax.Array, n_nodes, bucket_size
) -> Tuple[jax.Array, jax.Array]:
    """Per-node op codes {0: merge, 1: keep, 8/64/512/4096: split} and a
    convergence flag (csarray.hpp:285-348)."""
    dt = tree_keys.dtype
    lmax = max_tree_level(dt)
    cap = tree_keys.shape[0] - 1
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < n_nodes

    sib, level = _sibling_and_level(tree_keys, n_nodes)

    # parent (8-sibling-group) counts, gather-free: ws8[j] = sum of
    # counts[j..j+7] from three doubling shifted adds, then
    # parent_count[i] = ws8[i - sib] via the 8-way shift select: three
    # elementwise passes instead of a (cap, 8) gather.
    c64 = counts.astype(jnp.int64)
    s1 = c64 + _shift_up(c64, 1, jnp.int64(0))
    s2 = s1 + _shift_up(s1, 2, jnp.int64(0))
    ws8 = s2 + _shift_up(s2, 4, jnp.int64(0))
    parent_count = _select_shift_down(ws8, jnp.maximum(sib, 0), jnp.int64(0))

    bucket = jnp.asarray(bucket_size, dtype=jnp.int64)
    merge = (sib > 0) & (parent_count <= bucket)

    cnt = counts.astype(jnp.int64)
    op = jnp.ones((cap,), dtype=jnp.int32)
    op = jnp.where((cnt > bucket) & (level < lmax), jnp.int32(8), op)
    op = jnp.where((cnt > bucket * 8) & (level + 1 < lmax), jnp.int32(64), op)
    op = jnp.where((cnt > bucket * 64) & (level + 2 < lmax), jnp.int32(512), op)
    op = jnp.where((cnt > bucket * 512) & (level + 3 < lmax), jnp.int32(4096), op)
    op = jnp.where(merge, jnp.int32(0), op)
    op = jnp.where(valid, op, jnp.int32(0))

    converged = jnp.all(jnp.where(valid, op == 1, True))
    return op, converged


def rebalance_tree(
    tree_keys: jax.Array, node_ops: jax.Array, n_nodes
) -> Tuple[jax.Array, jax.Array]:
    """Emit the rebalanced tree from op codes (csarray.hpp:350-409).

    Searchsorted + gather formulation: the inclusive scan of the op codes
    gives every emitting source (op > 0) its output slot range
    [exc, inc); each output slot j finds its source (the unique emitter
    with exc <= j < inc) with one merged searchsorted over the scan, and
    ONE stacked row gather fetches the source's start key and packed
    (first output slot, new level) record. Slot j's key is then
    start + (j - first_slot) * nodeRange(new_level) — all elementwise.
    Returns (new_keys (cap+1,), new_n_nodes).
    """
    dt = tree_keys.dtype
    cap = tree_keys.shape[0] - 1
    lmax = max_tree_level(dt)

    ops = node_ops.astype(jnp.int32)
    inc = jnp.cumsum(ops)  # inclusive scan
    new_total = inc[-1]
    exc = inc - ops

    this = tree_keys[:-1]
    rng = tree_keys[1:] - this
    safe_rng = jnp.where(rng > 0, rng, node_range(dt, lmax))
    level = tree_level(safe_rng)
    level_diff = log8_ceil(node_ops.astype(dt))
    new_level = jnp.minimum(level + level_diff, lmax).astype(jnp.int32)

    # source of output slot j: the unique emitter m with exc[m] <= j <
    # inc[m], i.e. src(j) = #nodes with inc <= j. inc is monotone, so one
    # merged searchsorted answers every slot, and ONE stacked row-gather
    # fetches each source's (key, slot/level) record.
    from ..ops.primitives import multi_searchsorted

    j = jnp.arange(cap, dtype=jnp.int32)
    src = multi_searchsorted(inc, [j], side="right")[0]
    src = jnp.minimum(src, cap - 1)
    # packed record: 5 bits hold new_level (lmax <= 21); exc*32 stays far
    # below 2^31 for any capacity
    meta = exc * 32 + new_level
    if dt == jnp.uint64:
        rows = jnp.stack([
            (this >> jnp.uint64(32)).astype(jnp.uint32),
            this.astype(jnp.uint32),
            meta.astype(jnp.uint32),
        ], axis=-1)[src]
        key_fill = (
            rows[:, 0].astype(jnp.uint64) << jnp.uint64(32)
        ) | rows[:, 1].astype(jnp.uint64)
        meta_fill = rows[:, 2].astype(jnp.int32)
    else:
        rows = jnp.stack(
            [this.astype(jnp.uint32), meta.astype(jnp.uint32)], axis=-1
        )[src]
        key_fill = rows[:, 0].astype(dt)
        meta_fill = rows[:, 1].astype(jnp.int32)
    first_slot = meta_fill // 32
    lvl = meta_fill % 32

    s = (j - first_slot).astype(dt)
    new_key = key_fill + s * node_range(dt, lvl)
    end_key = node_range(dt, 0)
    new_keys = jnp.where(j < new_total, new_key, end_key)
    new_keys = jnp.concatenate([new_keys, jnp.full((1,), end_key, dtype=dt)])
    return new_keys, new_total


def update_octree(
    tree: CsArray, codes: jax.Array, bucket_size, max_count=MAX_UINT32, n_codes=None
) -> Tuple[CsArray, jax.Array]:
    """One rebalance + count step; returns (tree', converged)
    (csarray.hpp:411-448)."""
    ops, converged = rebalance_decision(tree.keys, tree.counts, tree.n_nodes, bucket_size)
    new_keys, new_n = rebalance_tree(tree.keys, ops, tree.n_nodes)
    new_counts = compute_node_counts(new_keys, codes, max_count, n_codes)
    return CsArray(keys=new_keys, counts=new_counts, n_nodes=new_n), converged


def uniform_tree(key_dtype, level: int, capacity: int) -> CsArray:
    """The complete uniform tree at `level` (8^level leaves).

    Used as a warm start for compute_octree: starting the fixed point at
    the expected depth instead of the root saves ~level rebalance+count
    iterations (each one costs a full searchsorted over the particles).
    The fixed point is unchanged — mergers coarsen overpopulated guesses
    exactly as splits refine underpopulated ones (csarray.hpp:285-348).
    """
    dt = np.dtype(key_dtype)
    n_nodes = 1 << (3 * level)
    assert n_nodes <= capacity, "uniform level exceeds capacity"
    lmax = max_tree_level(dt)
    shift = dt.type(3 * (lmax - level))
    end = dt.type(np.uint64(1) << np.uint64(3 * lmax))
    idx = jnp.arange(capacity + 1, dtype=dt)
    keys = jnp.where(idx <= n_nodes, idx << shift, end)
    counts = jnp.zeros((capacity,), dtype=jnp.uint32)
    return CsArray(keys=keys, counts=counts, n_nodes=jnp.int32(n_nodes))


@partial(jax.jit, static_argnames=("bucket_size", "capacity", "init_level"))
def _compute_octree_jit(codes, bucket_size, capacity, max_count, n_codes,
                        init_level=0, counts0=None):
    """Fixed-point tree build. `counts0` (only with init_level > 0) skips
    the initial count — callers that already built a grid-cell table at
    init_level pass its diffs (each count is a full searchsorted over the
    particle keys, the dominant per-iteration cost)."""
    if init_level > 0:
        tree0 = uniform_tree(codes.dtype, init_level, capacity)
    else:
        tree0 = root_tree(codes.dtype, capacity, n_particles=codes.shape[0])
    if counts0 is None or init_level == 0:
        counts0 = compute_node_counts(tree0.keys, codes, max_count, n_codes)
    tree0 = CsArray(keys=tree0.keys, counts=counts0, n_nodes=tree0.n_nodes)

    # decision carried in the state: an already-converged tree runs zero
    # loop bodies (no redundant emit + count)
    ops0, conv0 = rebalance_decision(
        tree0.keys, tree0.counts, tree0.n_nodes, bucket_size
    )

    def cond(state):
        _, _, stop = state
        return ~stop

    def body(state):
        tree, ops, _ = state
        new_keys, new_n = rebalance_tree(tree.keys, ops, tree.n_nodes)
        new_counts = compute_node_counts(new_keys, codes, max_count, n_codes)
        tree2 = CsArray(keys=new_keys, counts=new_counts, n_nodes=new_n)
        ops2, converged = rebalance_decision(
            new_keys, new_counts, new_n, bucket_size
        )
        overflow = new_n > capacity  # bail out; caller raises
        return tree2, ops2, converged | overflow

    tree, _, _ = jax.lax.while_loop(cond, body, (tree0, ops0, conv0))
    return tree


def default_init_level(n_particles: int, bucket_size: int, capacity: int) -> int:
    """Warm-start level for compute_octree: the uniform depth closest to
    n/bucket leaves, bounded so the uniform tree fits the capacity."""
    target = max(1, n_particles // max(1, bucket_size))
    level = max(0, int(np.floor(np.log(target) / np.log(8.0))))
    while (1 << (3 * level)) > capacity:
        level -= 1
    return max(0, level)


def compute_octree(
    codes: jax.Array,
    bucket_size: int,
    capacity: int | None = None,
    max_count=MAX_UINT32,
    n_codes=None,
    init_level: int | None = None,
) -> CsArray:
    """Fully converged cornerstone tree from sorted particle keys
    (csarray.hpp:450-465).

    `capacity` bounds the node count; if omitted, a heuristic based on
    n/bucket_size is used and overflow raises.
    """
    if capacity is None:
        n = int(codes.shape[0]) if n_codes is None else int(n_codes)
        capacity = _default_capacity(n, bucket_size)
    if init_level is None:
        n = int(codes.shape[0]) if n_codes is None else int(n_codes)
        init_level = default_init_level(n, int(bucket_size), int(capacity))
    tree = _compute_octree_jit(
        codes, int(bucket_size), int(capacity), max_count, n_codes,
        int(init_level),
    )
    if int(tree.n_nodes) > capacity:
        raise RuntimeError(
            f"octree capacity {capacity} exhausted (n_nodes={int(tree.n_nodes)}); "
            "pass a larger capacity"
        )
    return tree


def _default_capacity(n_particles: int, bucket_size: int) -> int:
    # a fully split tree has at most ~8/7 * n/bucket * 8 leaves in the worst
    # skew; pad generously and round to a friendly multiple of 1024
    est = max(4096, int(3.0 * max(1, n_particles) / max(1, bucket_size)) + 4096)
    return (est + 1023) // 1024 * 1024


def update_treelet_ops(
    treelet_keys: jax.Array, counts: jax.Array, n_nodes, bucket_size
) -> Tuple[jax.Array, jax.Array]:
    """Rebalance ops for a treelet (partial SFC cover) (csarray.hpp:467-488)."""
    return rebalance_decision(treelet_keys, counts, n_nodes, bucket_size)


def compute_spanning_tree(
    split_keys: jax.Array, n_splits, capacity: int
) -> Tuple[jax.Array, jax.Array]:
    """Minimal cornerstone tree containing the given boundary keys
    (csarray.hpp:490-531).

    split_keys: (m+1,) sorted, split_keys[0] == 0, split_keys[n_splits] ==
    nodeRange(0); entries beyond n_splits must repeat nodeRange(0).
    Returns (tree_keys (capacity+1,), n_nodes).
    """
    dt = split_keys.dtype
    m = split_keys.shape[0] - 1
    a = split_keys[:-1]
    b = split_keys[1:]
    idx = jnp.arange(m, dtype=jnp.int32)
    valid = (idx < n_splits) & (b > a)

    per_interval = jax.vmap(span_sfc_range_count)(a, b)
    per_interval = jnp.where(valid, per_interval, 0)
    inc = jnp.cumsum(per_interval)
    total = inc[-1]

    # emit each interval's cover into its slot range (gather formulation)
    j = jnp.arange(capacity, dtype=jnp.int32)
    seg = jnp.searchsorted(inc, j, side="right").astype(jnp.int32)
    seg = jnp.minimum(seg, m - 1)
    within = j - (inc[seg] - per_interval[seg])

    # the k-th key of interval i is a[i] plus the cumulative span increments;
    # reuse span_sfc_range per segment via vmap and gather the right element.
    # capacity per interval is bounded by the global capacity.
    def one(ai, bi):
        keys, _ = span_sfc_range(ai, bi, capacity)
        return keys

    all_keys = jax.vmap(one)(a, b)  # (m, capacity)
    end_key = node_range(dt, 0)
    keys_out = jnp.where(j < total, all_keys[seg, within], end_key)
    keys_out = jnp.concatenate([keys_out, jnp.full((1,), end_key, dtype=dt)])
    return keys_out, total
