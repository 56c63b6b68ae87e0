"""Parallel primitive wrappers in terms of XLA ops.

Replacements for the reference's primitives_gpu.cu catalog (reference:
include/cstone/primitives/primitives_gpu.h:39-126): sort/sort-by-key lower
to the variadic sort HLO, scans to cumsum/associative scans, and batched
lower_bound to a sort-based merge for multi-million-element inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "searchsorted",
    "multi_searchsorted",
    "sort_by_key",
    "exclusive_scan",
    "cumsum64",
    "segment_max",
    "segment_ids_from_offsets",
    "cubic_spline_w",
]


def cubic_spline_w(q):
    """Unnormalised cubic-spline SPH kernel W(q), q = r / h (the models/sph.py
    density contract). q may be inf for empty slots: that selects the 0
    branch."""
    w1 = 1.0 - 1.5 * q * q * (1.0 - 0.5 * q)
    w2 = 0.25 * (2.0 - q) ** 3
    return jnp.where(q < 1.0, w1, jnp.where(q < 2.0, w2, 0.0))


_SORT_METHOD_THRESHOLD = 1 << 16


def multi_searchsorted(a: jax.Array, queries, side: str = "left", sides=None):
    """Positions of several query sets in sorted `a` in ONE merged sort.

    Double-sort formulation (lowerBoundGpu's role, primitives_gpu.h:61-75,
    recast as sorts): stable-sort (concat(queries..., a),
    query-id) — concat order realizes the tie-break side — then rank each
    query among the a-elements by subtracting the running query count, and
    recover per-query order with a second sort keyed on query id. Unlike
    jnp's method="sort" it needs no rank scatter, and additional query
    sets ride the same two sorts.

    a: (n,) sorted; queries: sequence of 1-D arrays of a's dtype (need not
    be sorted). Returns list of int32 position arrays, one per query set.
    `sides` (optional) gives a per-set side ("left"/"right") overriding
    `side`: left sets concat before `a`, right sets after — so one merged
    sort can answer lower AND upper bounds (e.g. the membership test
    right - left >= 1 for unique-key arrays).
    """
    n = a.shape[0]
    sizes = [int(q.shape[0]) for q in queries]
    tq = sum(sizes)
    qs = [jnp.asarray(q, a.dtype) for q in queries]
    if sides is None:
        sides = [side] * len(qs)
    if not all(s in ("left", "right") for s in sides):
        raise ValueError(f"sides must be left|right, got {sides!r}")
    # global query ids follow the caller's set order; placement in the
    # concat follows the per-set side (stability realizes the tie-break)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    left_k = [q for q, s in zip(qs, sides) if s == "left"]
    left_i = [
        jnp.arange(offs[k], offs[k + 1], dtype=jnp.int32)
        for k, s in enumerate(sides) if s == "left"
    ]
    right_k = [q for q, s in zip(qs, sides) if s == "right"]
    right_i = [
        jnp.arange(offs[k], offs[k + 1], dtype=jnp.int32)
        for k, s in enumerate(sides) if s == "right"
    ]
    keys_all = jnp.concatenate(left_k + [a] + right_k)
    qid = jnp.concatenate(
        left_i + [jnp.full((n,), -1, jnp.int32)] + right_i
    )
    _, qid_s = jax.lax.sort((keys_all, qid), num_keys=1, is_stable=True)
    is_q = qid_s >= 0
    pos = jnp.arange(n + tq, dtype=jnp.int32)
    nq_incl = jnp.cumsum(is_q.astype(jnp.int32), dtype=jnp.int32)
    # for a query at merged pos p: rank among a = p - (#queries before p)
    rank = pos - nq_incl + 1
    # extraction: qids are unique, data rows (-1) land first
    _, rank_by_qid = jax.lax.sort((qid_s, rank), num_keys=1, is_stable=False)
    tail = rank_by_qid[n:]
    out = []
    off = 0
    for s in sizes:
        out.append(tail[off:off + s])
        off += s
    return out


def searchsorted(a: jax.Array, v: jax.Array, side: str = "left") -> jax.Array:
    """lower/upper_bound of v in sorted a.

    Uses the double-sort merge when the combined size is large (two sort
    HLOs instead of a log(n) gather scan), matching lowerBoundGpu's role
    (primitives_gpu.h:61-75).
    """
    if a.size + v.size >= _SORT_METHOD_THRESHOLD and v.ndim == a.ndim == 1:
        return multi_searchsorted(a, [v], side=side)[0]
    return jnp.searchsorted(a, v, side=side).astype(jnp.int32)


def sort_by_key(keys: jax.Array, *values: jax.Array, is_stable: bool = True):
    """Key-value sort via the variadic sort HLO (no gather)."""
    out = jax.lax.sort((keys,) + values, num_keys=1, is_stable=is_stable)
    return out[0], out[1:]


def exclusive_scan(x: jax.Array, axis: int = -1) -> jax.Array:
    """Exclusive prefix sum along axis."""
    inc = jnp.cumsum(x, axis=axis)
    return inc - x


def cumsum64(x: jax.Array) -> jax.Array:
    """Inclusive prefix sum of a 1-D 64-bit integer array.

    The work-efficient associative_scan builds the prefix from log2(n)
    elementwise adds + slices."""
    return jax.lax.associative_scan(jnp.add, x)


def segment_ids_from_offsets(
    offsets: jax.Array, n: int, num_segments: int
) -> jax.Array:
    """(n,) segment id per element from (num_segments+1,) offsets.

    Equivalent to searchsorted(offsets[1:], arange(n), side='right') but
    built from one small scatter-add plus one cumsum: the binary-search
    form gathers n indices log2(num_segments) times.
    Offsets clipped/out-of-range count as n (dropped).
    """
    offs = offsets[1:].astype(jnp.int32)
    hist = jnp.zeros((n + 1,), jnp.int32).at[offs].add(1, mode="drop")
    seg = jnp.cumsum(hist[:n], dtype=jnp.int32)
    return jnp.minimum(seg, num_segments - 1)


def segment_max(values: jax.Array, segment_offsets: jax.Array, num_segments: int) -> jax.Array:
    """Max over contiguous segments given by offsets (primitives_gpu.h:77-84).

    segment_offsets: (num_segments+1,) offsets into values; empty segments
    return 0.
    """
    n = values.shape[0]
    seg_id = segment_ids_from_offsets(segment_offsets, n, num_segments)
    return jax.ops.segment_max(
        values, seg_id, num_segments=num_segments, indices_are_sorted=True
    )
