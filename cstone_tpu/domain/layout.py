"""Particle buffer layout: leaf cells -> particle index ranges.

JAX equivalent of the reference's layout computation (reference:
include/cstone/domain/layout.hpp). On a single device the layout is the
exclusive scan of leaf counts; in the distributed Domain only cells that
are locally present (assigned or halo) contribute (layout.hpp:150-164).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["leaf_layout_from_counts", "compute_node_layout"]


def leaf_layout_from_counts(counts: jax.Array) -> jax.Array:
    """Exclusive scan of per-leaf counts -> (cap_leaf+1,) particle offsets."""
    c = counts.astype(jnp.int32)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(c)])


def compute_node_layout(
    leaf_counts: jax.Array, halo_flags: jax.Array, first_assigned, last_assigned
) -> jax.Array:
    """Offsets including only halo-flagged or locally assigned cells
    (layout.hpp:150-164).

    leaf_counts: (cap_leaf,) uint32; halo_flags: (cap_leaf,) bool/int;
    [first_assigned, last_assigned): leaf index range owned by this rank.
    """
    cap = leaf_counts.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    assigned = (idx >= first_assigned) & (idx < last_assigned)
    present = assigned | (halo_flags.astype(bool))
    masked = jnp.where(present, leaf_counts.astype(jnp.int32), 0)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(masked)])
