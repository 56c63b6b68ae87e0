"""Parallel binary radix tree over sorted SFC keys (Karras 2012).

JAX equivalent of the reference's binary tree (reference:
include/cstone/tree/btree.hpp:86-269, btree.cuh). Kept, like the
reference, as the historical/alternative construction for collision
detection; the production halo path traverses the linked octree directly
(btree.hpp:34-51). The per-node split search is fully vectorized: every
internal node finds its coverage direction and range with exponential
probing + bisection expressed as static log2-depth loops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from ..sfc.keys import common_prefix

__all__ = ["BinaryTree", "build_binary_tree"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BinaryTree:
    """n-1 internal nodes over n sorted keys (btree.hpp:86-108).

    left/right: child indices; values >= n_internal encode leaf index
    (child - n_internal). prefix: common prefix length per node.
    """

    left: jax.Array
    right: jax.Array
    prefix_length: jax.Array
    n_internal: jax.Array


def _delta(keys: jax.Array, i: jax.Array, j: jax.Array, n: jax.Array) -> jax.Array:
    """Common-prefix length of keys i and j; -1 out of bounds."""
    cap = keys.shape[0]
    ok = (j >= 0) & (j < n) & (i >= 0) & (i < n)
    ii = jnp.clip(i, 0, cap - 1)
    jj = jnp.clip(j, 0, cap - 1)
    d = common_prefix(keys[ii], keys[jj])
    return jnp.where(ok, d, -1)


def build_binary_tree(keys: jax.Array, n_keys) -> BinaryTree:
    """Construct the radix tree over sorted, unique keys (btree.hpp:110-180).

    keys: (cap,) sorted unique SFC keys; first n_keys valid.
    """
    cap = keys.shape[0]
    n = jnp.asarray(n_keys, jnp.int32)
    n_internal = jnp.maximum(n - 1, 0)
    i = jnp.arange(cap, dtype=jnp.int32)

    # direction: toward the neighbor with the longer common prefix
    d = jnp.where(_delta(keys, i, i + 1, n) > _delta(keys, i, i - 1, n), 1, -1)
    d = d.astype(jnp.int32)
    delta_min = _delta(keys, i, i - d, n)

    # find range end: exponential probe then shrink (static log-depth loops)
    lmax = jnp.full((cap,), 2, dtype=jnp.int32)
    nbits = jnp.iinfo(keys.dtype).bits
    for _ in range(nbits):  # until probe exceeds the span; log2(cap) enough
        probe = _delta(keys, i, i + lmax * d, n)
        grow = probe > delta_min
        lmax = jnp.where(grow, lmax * 2, lmax)
    length = jnp.zeros((cap,), dtype=jnp.int32)
    t = lmax // 2
    for _ in range(nbits):
        cand = length + t
        ok = _delta(keys, i, i + cand * d, n) > delta_min
        length = jnp.where(ok & (t > 0), cand, length)
        t = t // 2
    j = i + length * d  # other end of the range

    # split position: highest point where prefix exceeds node prefix
    delta_node = _delta(keys, i, j, n)
    s = jnp.zeros((cap,), dtype=jnp.int32)
    t = (length + 1) // 2
    for _ in range(nbits):
        cand = s + t
        ok = _delta(keys, i, i + cand * d, n) > delta_node
        s = jnp.where(ok & (t > 0), cand, s)
        t = jnp.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + jnp.minimum(d, 0)

    lo = jnp.minimum(i, j)
    hi = jnp.maximum(i, j)
    left = jnp.where(lo == gamma, gamma + n_internal, gamma)
    right = jnp.where(hi == gamma + 1, gamma + 1 + n_internal, gamma + 1)

    valid = i < n_internal
    return BinaryTree(
        left=jnp.where(valid, left, 0),
        right=jnp.where(valid, right, 0),
        prefix_length=jnp.where(valid, delta_node, 0),
        n_internal=n_internal,
    )
