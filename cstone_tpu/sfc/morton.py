"""3D Morton encoding/decoding in 32- and 64-bit, vectorized over whole arrays.

Bit-for-bit compatible with the reference's magic-number method
(reference: include/cstone/sfc/morton.hpp), but expressed as elementwise
jnp ops over whole coordinate arrays that XLA fuses into one pass.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .keys import max_tree_level

__all__ = ["expand_bits", "compact_bits", "imorton", "decode_morton"]

_U32 = np.dtype(np.uint32)
_U64 = np.dtype(np.uint64)


def expand_bits(v: jax.Array, key_dtype) -> jax.Array:
    """Insert 2 zero bits after each of the low 10/21 bits (morton.hpp:50-87)."""
    dt = np.dtype(key_dtype)
    if dt == _U32:
        v = v.astype(jnp.uint32)
        v &= jnp.uint32(0x000003FF)
        v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
        v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
        v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
        v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
        return v
    x = v.astype(jnp.uint64) & jnp.uint64(0x1FFFFF)
    x = (x | (x << 32)) & jnp.uint64(0x001F00000000FFFF)
    x = (x | (x << 16)) & jnp.uint64(0x001F0000FF0000FF)
    x = (x | (x << 8)) & jnp.uint64(0x100F00F00F00F00F)
    x = (x | (x << 4)) & jnp.uint64(0x10C30C30C30C30C3)
    x = (x | (x << 2)) & jnp.uint64(0x1249249249249249)
    return x


def compact_bits(v: jax.Array) -> jax.Array:
    """Inverse of expand_bits: keep every 3rd bit (morton.hpp:62-102)."""
    if v.dtype == jnp.uint32:
        v &= jnp.uint32(0x09249249)
        v = (v ^ (v >> 2)) & jnp.uint32(0x030C30C3)
        v = (v ^ (v >> 4)) & jnp.uint32(0x0300F00F)
        v = (v ^ (v >> 8)) & jnp.uint32(0xFF0000FF)
        v = (v ^ (v >> 16)) & jnp.uint32(0x000003FF)
        return v
    v = v.astype(jnp.uint64)
    v &= jnp.uint64(0x1249249249249249)
    v = (v ^ (v >> 2)) & jnp.uint64(0x10C30C30C30C30C3)
    v = (v ^ (v >> 4)) & jnp.uint64(0x100F00F00F00F00F)
    v = (v ^ (v >> 8)) & jnp.uint64(0x001F0000FF0000FF)
    v = (v ^ (v >> 16)) & jnp.uint64(0x001F00000000FFFF)
    v = (v ^ (v >> 32)) & jnp.uint64(0x00000000001FFFFF)
    return v


def imorton(ix: jax.Array, iy: jax.Array, iz: jax.Array, key_dtype) -> jax.Array:
    """Morton key from integer grid coordinates in [0, 2^maxLevel) (morton.hpp:111-125)."""
    dt = np.dtype(key_dtype)
    xx = expand_bits(ix, dt)
    yy = expand_bits(iy, dt)
    zz = expand_bits(iz, dt)
    four = dt.type(4)
    two = dt.type(2)
    return xx * four + yy * two + zz


def decode_morton(code: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Integer grid coordinates from a Morton key (morton.hpp:143-168)."""
    ix = compact_bits(code >> 2)
    iy = compact_bits(code >> 1)
    iz = compact_bits(code)
    return ix.astype(jnp.uint32), iy.astype(jnp.uint32), iz.astype(jnp.uint32)
