"""Bit-level primitives on integer lanes.

JAX replacement for the reference's clz/popcount foundation
(reference: include/cstone/primitives/clz.hpp). All functions are
elementwise over jnp arrays of uint32/uint64 and fully vectorizable;
`jax.lax.clz` / `population_count` lower to single HW ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "count_leading_zeros",
    "count_trailing_zeros",
    "bit_width",
]


def count_leading_zeros(x: jax.Array) -> jax.Array:
    """Number of leading zero bits; returns the type width for x == 0.

    Matches reference countLeadingZeros (clz.hpp:40-55): clz32(0) == 32,
    clz64(0) == 64.
    """
    if not jnp.issubdtype(x.dtype, jnp.integer):
        raise TypeError(f"count_leading_zeros requires integer dtype, got {x.dtype}")
    return jax.lax.clz(x).astype(jnp.int32)


def count_trailing_zeros(x: jax.Array) -> jax.Array:
    """Number of trailing zero bits; returns the type width for x == 0.

    Matches reference countTrailingZeros (clz.hpp:120-143).
    """
    nbits = jnp.iinfo(x.dtype).bits
    # isolate lowest set bit: x & (-x); ctz = bits - 1 - clz(lowbit); 0 -> bits
    low = x & (jnp.zeros_like(x) - x)
    ctz = nbits - 1 - jax.lax.clz(low).astype(jnp.int32)
    return jnp.where(x == 0, jnp.int32(nbits), ctz)


def bit_width(x: jax.Array) -> jax.Array:
    """Position of the highest set bit plus one (0 for x == 0)."""
    nbits = jnp.iinfo(x.dtype).bits
    return jnp.int32(nbits) - jax.lax.clz(x).astype(jnp.int32)
