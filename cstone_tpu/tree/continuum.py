"""Cornerstone trees from analytic particle-concentration functions.

JAX equivalent of the reference's continuum trees (reference:
include/cstone/tree/continuum.hpp) — a testing aid that builds a tree from
a density field instead of particles: each node's count is estimated from
the concentration sampled at its 8 corners times its volume.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from ..sfc.box import Box, center_and_size
from ..sfc.encode import HILBERT, sfc_ibox
from ..sfc.keys import max_tree_level, node_range, tree_level
from .csarray import CsArray, rebalance_decision, rebalance_tree, root_tree

__all__ = ["continuum_counts", "compute_continuum_csarray"]


def continuum_counts(
    tree_keys: jax.Array, n_nodes, box: Box, concentration: Callable,
    curve: str = HILBERT,
) -> jax.Array:
    """Estimated particle count per leaf (continuum.hpp:40-71)."""
    dt = tree_keys.dtype
    cap = tree_keys.shape[0] - 1
    key = tree_keys[:-1]
    rng = tree_keys[1:] - key
    safe = jnp.where(rng > 0, rng, node_range(dt, max_tree_level(dt)))
    level = tree_level(safe)
    ibox = sfc_ibox(key, level, curve)
    center, size = center_and_size(ibox, box, dt)

    volume = size[:, 0] * size[:, 1] * size[:, 2]
    count = jnp.zeros((cap,), dtype=jnp.float64 if center.dtype == jnp.float64
                      else jnp.float32)
    for ix in (-1, 1):
        for iy in (-1, 1):
            for iz in (-1, 1):
                cx = center[:, 0] + 0.5 * ix * size[:, 0]
                cy = center[:, 1] + 0.5 * iy * size[:, 1]
                cz = center[:, 2] + 0.5 * iz * size[:, 2]
                count = count + concentration(cx, cy, cz) * volume

    valid = jnp.arange(cap, dtype=jnp.int32) < n_nodes
    count = jnp.where(valid, jnp.round(count), 0.0)
    return jnp.minimum(count, 2.0**32 - 1).astype(jnp.uint32)


def compute_continuum_csarray(
    concentration: Callable,
    box: Box,
    bucket_size: int,
    capacity: int,
    key_dtype,
    max_iterations: int = 10,
    curve: str = HILBERT,
) -> CsArray:
    """Converged tree from a concentration field (continuum.hpp:93-115)."""
    tree = root_tree(key_dtype, capacity, n_particles=bucket_size + 1)

    def body(state):
        t, _, it = state
        ops, converged = rebalance_decision(t.keys, t.counts, t.n_nodes, bucket_size)
        nk, nn = rebalance_tree(t.keys, ops, t.n_nodes)
        nc = continuum_counts(nk, nn, box, concentration, curve)
        return CsArray(keys=nk, counts=nc, n_nodes=nn), converged, it + 1

    def cond(state):
        _, converged, it = state
        return (~converged) & (it < max_iterations)

    tree, _, _ = jax.lax.while_loop(
        cond, body, (tree, jnp.bool_(False), jnp.int32(0))
    )
    return tree
