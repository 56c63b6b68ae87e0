"""3D Hilbert encoding/decoding in 32- and 64-bit, vectorized over whole arrays.

Produces keys identical to the reference's GOTHIC-derived curve
(reference: include/cstone/sfc/hilbert.hpp), re-designed as a fixed-trip
`lax.fori_loop` over levels where every iteration is pure elementwise
integer math over the whole coordinate array (no lookup tables, no
per-element control flow).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .keys import max_tree_level

__all__ = [
    "ihilbert",
    "ihilbert_top",
    "decode_hilbert",
    "ihilbert_2d",
    "decode_hilbert_2d",
]


def _morton_to_hilbert(octant: jax.Array) -> jax.Array:
    """The {0,1,3,2,7,6,4,5} child reordering as closed-form bit math.

    Equals grayCode(octant) ^ (octant >> 2), replacing the reference's
    lookup table (hilbert.hpp:49,67) with arithmetic that vectorizes.
    """
    return (octant ^ (octant >> 1)) ^ (octant >> 2)


def ihilbert(px: jax.Array, py: jax.Array, pz: jax.Array, key_dtype) -> jax.Array:
    """Hilbert key from integer grid coordinates in [0, 2^maxLevel).

    Matches reference iHilbert (hilbert.hpp:58-109): per level, append the
    reordered octant to the key, then apply the axis reflections and the
    conditional rotation/swap — all expressed with masks and `where`.
    """
    dt = np.dtype(key_dtype)
    lmax = max_tree_level(dt)

    px = px.astype(jnp.uint32)
    py = py.astype(jnp.uint32)
    pz = pz.astype(jnp.uint32)
    key = jnp.zeros(jnp.broadcast_shapes(px.shape, py.shape, pz.shape), dtype=dt)

    one = jnp.uint32(1)
    zero = jnp.uint32(0)

    def body(i, carry):
        px, py, pz, key = carry
        level = (jnp.uint32(lmax - 1) - i.astype(jnp.uint32))

        xi = (px >> level) & one
        yi = (py >> level) & one
        zi = (pz >> level) & one

        octant = (xi << one + one) | (yi << one) | zi
        key = (key << dt.type(3)) + _morton_to_hilbert(octant).astype(dt)

        not_yi = yi ^ one
        not_zi = zi ^ one

        # turn px, py, pz: x ^= -mask  (mask in {0,1}; -1 == all ones)
        mx = xi & (not_yi | zi)
        my = (xi & (yi | zi)) | (yi & not_zi)
        mz = (xi & not_yi & not_zi) | (yi & not_zi)
        px = px ^ (zero - mx)
        py = py ^ (zero - my)
        pz = pz ^ (zero - mz)

        # if zi: cyclic rotation (px,py,pz) <- (py,pz,px)
        # elif !yi: swap px and pz
        rot = zi == one
        swp = (zi == zero) & (yi == zero)
        npx = jnp.where(rot, py, jnp.where(swp, pz, px))
        npy = jnp.where(rot, pz, py)
        npz = jnp.where(rot, px, jnp.where(swp, px, pz))

        return npx, npy, npz, key

    _, _, _, key = jax.lax.fori_loop(0, lmax, body, (px, py, pz, key))
    return key


def ihilbert_top(
    px: jax.Array, py: jax.Array, pz: jax.Array, levels: int, lmax: int
) -> jax.Array:
    """Top 3*levels bits of the depth-lmax Hilbert key, as uint32.

    Runs only the first `levels` rounds of the ihilbert level loop (the
    per-round math is identical), so the result equals
    `ihilbert(px,py,pz) >> 3*(lmax-levels)`. The Hilbert rounds consume
    coordinate bits top-down, which is what makes this prefix property
    hold. Requires 3*levels <= 30. Used for coarse grid-cell keys
    (traversal/cover.py) where a full-depth 64-bit encode would waste
    15 of 21 rounds in emulated u64 arithmetic.
    """
    assert 3 * levels <= 30
    px = px.astype(jnp.uint32)
    py = py.astype(jnp.uint32)
    pz = pz.astype(jnp.uint32)
    key = jnp.zeros(jnp.broadcast_shapes(px.shape, py.shape, pz.shape), jnp.uint32)

    one = jnp.uint32(1)
    zero = jnp.uint32(0)

    def body(i, carry):
        px, py, pz, key = carry
        level = jnp.uint32(lmax - 1) - i.astype(jnp.uint32)

        xi = (px >> level) & one
        yi = (py >> level) & one
        zi = (pz >> level) & one

        octant = (xi << one + one) | (yi << one) | zi
        key = (key << jnp.uint32(3)) + _morton_to_hilbert(octant)

        not_yi = yi ^ one
        not_zi = zi ^ one
        mx = xi & (not_yi | zi)
        my = (xi & (yi | zi)) | (yi & not_zi)
        mz = (xi & not_yi & not_zi) | (yi & not_zi)
        px = px ^ (zero - mx)
        py = py ^ (zero - my)
        pz = pz ^ (zero - mz)

        rot = zi == one
        swp = (zi == zero) & (yi == zero)
        npx = jnp.where(rot, py, jnp.where(swp, pz, px))
        npy = jnp.where(rot, pz, py)
        npz = jnp.where(rot, px, jnp.where(swp, px, pz))
        return npx, npy, npz, key

    _, _, _, key = jax.lax.fori_loop(0, levels, body, (px, py, pz, key))
    return key


def decode_hilbert(key: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Inverse of ihilbert (hilbert.hpp:145-188)."""
    dt = key.dtype
    lmax = max_tree_level(dt)

    shape = key.shape
    px = jnp.zeros(shape, dtype=jnp.uint32)
    py = jnp.zeros(shape, dtype=jnp.uint32)
    pz = jnp.zeros(shape, dtype=jnp.uint32)
    one = jnp.uint32(1)
    zero = jnp.uint32(0)

    def body(i, carry):
        px, py, pz = carry
        level = i.astype(jnp.uint32)
        shift = (level * jnp.uint32(3)).astype(dt)
        octant = ((key >> shift) & dt.type(7)).astype(jnp.uint32)
        xi = octant >> 2
        yi = (octant >> 1) & one
        zi = octant & one

        # if yi^zi: cyclic rotation (px,py,pz) <- (pz,px,py)
        # elif (octant==0 or octant==7): swap px and pz
        rot = (yi ^ zi) == one
        swp = (~rot) & ((octant == 0) | (octant == 7))
        npx = jnp.where(rot, pz, jnp.where(swp, pz, px))
        npy = jnp.where(rot, px, py)
        npz = jnp.where(rot, py, jnp.where(swp, px, pz))
        px, py, pz = npx, npy, npz

        not_xi = xi ^ one
        not_yi = yi ^ one
        not_zi = zi ^ one

        mask = (one << level) - one
        mx = xi & (yi | zi)
        my = (xi & (not_yi | not_zi)) | (not_xi & yi & zi)
        mz = (xi & not_yi & not_zi) | (yi & zi)
        px = px ^ (mask & (zero - mx))
        py = py ^ (mask & (zero - my))
        pz = pz ^ (mask & (zero - mz))

        px = px | (xi << level)
        py = py | ((xi ^ yi) << level)
        pz = pz | ((yi ^ zi) << level)
        return px, py, pz

    px, py, pz = jax.lax.fori_loop(0, lmax, body, (px, py, pz))
    return px, py, pz


def ihilbert_2d(px: jax.Array, py: jax.Array, key_dtype) -> jax.Array:
    """2D Hilbert key (hilbert.hpp:118-142)."""
    dt = np.dtype(key_dtype)
    lmax = max_tree_level(dt)
    px = px.astype(jnp.uint32)
    py = py.astype(jnp.uint32)
    key = jnp.zeros(jnp.broadcast_shapes(px.shape, py.shape), dtype=dt)
    one = jnp.uint32(1)
    zero = jnp.uint32(0)

    def body(i, carry):
        px, py, key = carry
        level = jnp.uint32(lmax - 1) - i.astype(jnp.uint32)
        xi = (px >> level) & one
        yi = (py >> level) & one

        # if yi == 0: swap x/y, complementing when xi == 1
        neg_xi = zero - xi
        npx = jnp.where(yi == zero, py ^ neg_xi, px)
        npy = jnp.where(yi == zero, px ^ neg_xi, py)
        key = key * dt.type(4) + (jnp.uint32(2) * xi + (xi ^ yi)).astype(dt)
        return npx, npy, key

    _, _, key = jax.lax.fori_loop(0, lmax, body, (px, py, key))
    return key


def decode_hilbert_2d(key: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Inverse of ihilbert_2d, Lam-Shapiro style (hilbert.hpp:191-222)."""
    dt = key.dtype
    order = max_tree_level(dt)
    x = jnp.zeros(key.shape, dtype=jnp.uint32)
    y = jnp.zeros(key.shape, dtype=jnp.uint32)
    zero = jnp.uint32(0)

    def body(i, carry):
        x, y = carry
        level = (i.astype(jnp.uint32) * jnp.uint32(2)).astype(dt)
        sa = ((key >> (level + dt.type(1))) & dt.type(1)).astype(jnp.uint32)
        sb = ((key >> level) & dt.type(1)).astype(jnp.uint32)

        neg_sa = zero - sa
        swap = (sa ^ sb) == zero
        nx = jnp.where(swap, y ^ neg_sa, x)
        ny = jnp.where(swap, x ^ neg_sa, y)
        x = (nx >> 1) | (sa << 31)
        y = (ny >> 1) | ((sa ^ sb) << 31)
        return x, y

    x, y = jax.lax.fori_loop(0, order, body, (x, y))
    return x >> (32 - order), y >> (32 - order)
