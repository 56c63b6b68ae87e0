"""Box overlap / distance math for tree traversals, vectorized.

JAX equivalent of the reference's overlap tests (reference:
include/cstone/traversal/boxoverlap.hpp). All functions operate on batches
of boxes/points at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..sfc.box import Box, IBox, apply_pbc
from ..sfc.keys import max_tree_level, to_nbit_int_ceil
from ..sfc.encode import isfc_key
from ..sfc.keys import smallest_common_box

__all__ = [
    "overlap_ranges_pbc",
    "overlap_iboxes",
    "contained_in_keys",
    "make_halo_box",
    "inside_box",
    "min_distance_point_box",
    "min_distance_boxes",
]


def overlap_ranges_pbc(a, b, c, d, R: int) -> jax.Array:
    """Periodic 1D range overlap test (boxoverlap.hpp:40-70)."""
    def two(a, b, c, d):
        return (b > c) & (d > a)

    return two(a, b, c, d) | two(a + R, b + R, c, d) | two(a, b, c + R, d + R)


def overlap_iboxes(a: IBox, b: IBox, key_dtype) -> jax.Array:
    """PBC-aware integer box overlap (boxoverlap.hpp:72-83)."""
    R = 1 << max_tree_level(key_dtype)
    return (
        overlap_ranges_pbc(a.xmin, a.xmax, b.xmin, b.xmax, R)
        & overlap_ranges_pbc(a.ymin, a.ymax, b.ymin, b.ymax, R)
        & overlap_ranges_pbc(a.zmin, a.zmax, b.zmin, b.zmax, R)
    )


def contained_in_keys(ibox: IBox, code_start, code_end, key_dtype, curve="hilbert") -> jax.Array:
    """True where `ibox` lies fully inside the SFC key range
    (boxoverlap.hpp:85-116)."""
    R = 1 << max_tree_level(key_dtype)
    wraps = (
        (jnp.minimum(jnp.minimum(ibox.xmin, ibox.ymin), ibox.zmin) < 0)
        | (jnp.maximum(jnp.maximum(ibox.xmax, ibox.ymax), ibox.zmax) > R)
    )
    low = isfc_key(
        ibox.xmin.astype(jnp.uint32), ibox.ymin.astype(jnp.uint32), ibox.zmin.astype(jnp.uint32),
        key_dtype, curve,
    )
    high = isfc_key(
        (ibox.xmax - 1).astype(jnp.uint32),
        (ibox.ymax - 1).astype(jnp.uint32),
        (ibox.zmax - 1).astype(jnp.uint32),
        key_dtype, curve,
    )
    env_lo, env_hi = smallest_common_box(low, high)
    inside = (env_lo >= code_start) & (env_hi <= code_end)
    import numpy as np

    root_end = jnp.asarray(np.uint64(1) << np.uint64(3 * max_tree_level(key_dtype)), dtype=low.dtype)
    wrapped_ok = (code_start == 0) & (code_end == root_end)
    return jnp.where(wraps, wrapped_ok, inside)


def make_halo_box(node_ibox: IBox, radius, box: Box, key_dtype) -> IBox:
    """Dilate integer node boxes by a float radius, clamped or wrapped per
    dimension (boxoverlap.hpp:145-172)."""
    R = 1 << max_tree_level(key_dtype)
    iL = (1.0 / box.lengths).astype(jnp.float64 if box.limits.dtype == jnp.float64 else jnp.float32)
    r = jnp.asarray(radius)
    dx = to_nbit_int_ceil(r * iL[0], key_dtype)
    dy = to_nbit_int_ceil(r * iL[1], key_dtype)
    dz = to_nbit_int_ceil(r * iL[2], key_dtype)

    pbc = box.periodic_mask

    def add(value, delta, is_pbc):
        t = value + delta
        if is_pbc:
            return t
        return jnp.clip(t, 0, R)

    return IBox(
        add(node_ibox.xmin, -dx, pbc[0]),
        add(node_ibox.xmax, dx, pbc[0]),
        add(node_ibox.ymin, -dy, pbc[1]),
        add(node_ibox.ymax, dy, pbc[1]),
        add(node_ibox.zmin, -dz, pbc[2]),
        add(node_ibox.zmax, dz, pbc[2]),
    )


def inside_box(center: jax.Array, size: jax.Array, box: Box) -> jax.Array:
    """True where the cuboid (center ± size) lies inside `box`
    (boxoverlap.hpp:184-194). center/size: (..., 3)."""
    mins = box.mins.astype(center.dtype)
    maxs = box.maxs.astype(center.dtype)
    lo = center - size
    hi = center + size
    return jnp.all(lo >= mins, axis=-1) & jnp.all(hi <= maxs, axis=-1)


def min_distance_point_box(X: jax.Array, center: jax.Array, size: jax.Array,
                           box: Box | None = None) -> jax.Array:
    """Smallest distance vector from points to boxes; 0 inside
    (boxoverlap.hpp:196-217). Shapes broadcast on (..., 3)."""
    if box is None:
        dX = jnp.abs(center - X) - size
    else:
        dX = jnp.abs(apply_pbc(center - X, box)) - size
    return jnp.maximum(dX, 0)


def min_distance_boxes(a_center, a_size, b_center, b_size, box: Box | None = None) -> jax.Array:
    """Smallest distance vector between two boxes; 0 when overlapping
    (boxoverlap.hpp:219-244)."""
    if box is None:
        dX = jnp.abs(b_center - a_center) - a_size - b_size
    else:
        dX = jnp.abs(apply_pbc(b_center - a_center, box)) - a_size - b_size
    return jnp.maximum(dX, 0)
