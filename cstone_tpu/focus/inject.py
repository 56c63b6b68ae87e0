"""Forced key injection into a cornerstone leaf array.

JAX equivalent of the reference's injectKeys (reference:
include/cstone/focus/inject.hpp:52-111): when the focus rebalance cannot
resolve a mandatory key by splitting one level, the full spanning cover of
the key is spliced into the tree directly. Static-shape version: append
the spanning keys of all mandatory intervals, sort, deduplicate by
compaction, and keep the cornerstone invariants via the spanning covers.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..sfc.keys import node_range, span_sfc_range

__all__ = ["inject_keys"]


def inject_keys(
    leaves: jax.Array,
    n_leaf,
    mandatory_keys: jax.Array,
    n_keys=None,
    span_cap: int = 64,
) -> Tuple[jax.Array, jax.Array]:
    """Insert spanning covers of mandatory keys into the leaf array.

    leaves: (cap_leaf+1,) padded cornerstone keys.
    mandatory_keys: (k,) keys that must exist as node boundaries.
    Returns (new_leaves, new_n_leaf). Requires cap to absorb up to
    k * 2 * span_cap extra keys; surplus is reported via new_n_leaf which
    may exceed capacity (caller checks).
    """
    dt = leaves.dtype
    cap = leaves.shape[0] - 1
    end_key = node_range(dt, 0)
    kk = mandatory_keys.shape[0]

    active = jnp.ones((kk,), dtype=bool)
    if n_keys is not None:
        active = jnp.arange(kk, dtype=jnp.int32) < n_keys
    active = active & (mandatory_keys != 0) & (mandatory_keys != end_key)

    # spanning covers [0, key) and [key, end) give all ancestor boundaries
    def covers(key):
        lo, n_lo = span_sfc_range(dt.type(0), key, span_cap)
        hi, n_hi = span_sfc_range(key, end_key, span_cap)
        return lo, n_lo, hi, n_hi

    lo, n_lo, hi, n_hi = jax.vmap(covers)(jnp.where(active, mandatory_keys, end_key))
    pad_mask_lo = jnp.arange(span_cap)[None, :] < jnp.where(active, n_lo, 0)[:, None]
    pad_mask_hi = jnp.arange(span_cap)[None, :] < jnp.where(active, n_hi, 0)[:, None]
    extra = jnp.concatenate([
        jnp.where(pad_mask_lo, lo, end_key).reshape(-1),
        jnp.where(pad_mask_hi, hi, end_key).reshape(-1),
    ])

    merged = jnp.concatenate([leaves, extra])
    merged = jnp.sort(merged)

    # deduplicate by compaction (keep first of each run)
    keep = jnp.concatenate([jnp.ones((1,), bool), merged[1:] != merged[:-1]])
    # everything >= end_key collapses into the single terminal entry
    keep = keep & (merged <= end_key)
    rank = jnp.cumsum(keep.astype(jnp.int32)) - keep.astype(jnp.int32)
    out = jnp.full((cap + 1,), end_key, dtype=dt)
    ok = keep & (rank <= cap)
    out = out.at[jnp.where(ok, rank, cap + 1)].set(merged, mode="drop")
    n_unique = jnp.sum(keep.astype(jnp.int32))  # includes leading 0 + end key
    return out, n_unique - 1
