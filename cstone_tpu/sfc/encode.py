"""Unified SFC key API: float coordinates -> Morton/Hilbert keys and back.

JAX equivalent of the reference's sfc.hpp + sfc_gpu.cu (reference:
include/cstone/sfc/sfc.hpp:157-292, sfc_gpu.cu:39-77). The batch encode is
one fused elementwise pipeline over the full coordinate arrays; the default
curve is Hilbert, like the reference (sfc.hpp:55).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import hilbert as _hilbert
from . import morton as _morton
from .box import Box, IBox, pbc_adjust
from .keys import (
    common_prefix,
    enclosing_box_code,
    encode_placeholder_bit,
    max_tree_level,
    remove_key,
    tree_level,
)

__all__ = [
    "MORTON",
    "HILBERT",
    "isfc_key",
    "isfc_key_top",
    "decode_sfc",
    "sfc3d",
    "compute_sfc_keys",
    "sfc_ibox",
    "sfc_ibox_keys",
    "common_node_prefix",
    "sfc_neighbor",
]

MORTON = "morton"
HILBERT = "hilbert"  # library-wide default, like the reference (sfc.hpp:55)


def isfc_key(ix, iy, iz, key_dtype, curve: str = HILBERT) -> jax.Array:
    """Integer coordinates -> SFC key (sfc.hpp:143-155)."""
    if curve == MORTON:
        return _morton.imorton(ix, iy, iz, key_dtype)
    if curve == HILBERT:
        return _hilbert.ihilbert(ix, iy, iz, key_dtype)
    raise ValueError(f"unknown curve {curve!r}")


def isfc_key_top(
    ix, iy, iz, levels: int, lmax: int, curve: str = HILBERT
) -> jax.Array:
    """Top 3*levels bits of the depth-lmax key, as uint32 — equal to
    `isfc_key(...) >> 3*(lmax-levels)`. Cheap coarse-cell encode: runs
    only `levels` rounds (Hilbert) / expands only the top bits (Morton).
    """
    if curve == MORTON:
        ls = np.uint32(lmax - levels)
        return _morton.imorton(
            ix.astype(jnp.uint32) >> ls,
            iy.astype(jnp.uint32) >> ls,
            iz.astype(jnp.uint32) >> ls,
            jnp.uint32,
        ).astype(jnp.uint32)
    if curve == HILBERT:
        return _hilbert.ihilbert_top(ix, iy, iz, levels, lmax)
    raise ValueError(f"unknown curve {curve!r}")


def decode_sfc(key: jax.Array, curve: str = HILBERT):
    """SFC key -> integer coordinates (sfc.hpp:196-210)."""
    if curve == MORTON:
        return _morton.decode_morton(key)
    if curve == HILBERT:
        return _hilbert.decode_hilbert(key)
    raise ValueError(f"unknown curve {curve!r}")


def _grid_coords(x, y, z, box: Box, key_dtype) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Float coords -> integer grid coords, replicating sfc3D (sfc.hpp:157-175).

    ix = min(floor(x * mx) - xmin * mx, maxCoord-1) with mx = 2^maxLevel / L.
    """
    cube = 1 << max_tree_level(key_dtype)
    fdt = x.dtype
    iL = (1.0 / box.lengths).astype(fdt)
    m = fdt.type(cube) * iL  # (3,)
    mins = box.mins.astype(fdt)

    mcoord = jnp.int32((1 << max_tree_level(key_dtype)) - 1)
    ix = (jnp.floor(x * m[0]) - mins[0] * m[0]).astype(jnp.int32)
    iy = (jnp.floor(y * m[1]) - mins[1] * m[1]).astype(jnp.int32)
    iz = (jnp.floor(z * m[2]) - mins[2] * m[2]).astype(jnp.int32)
    ix = jnp.minimum(ix, mcoord)
    iy = jnp.minimum(iy, mcoord)
    iz = jnp.minimum(iz, mcoord)
    return ix.astype(jnp.uint32), iy.astype(jnp.uint32), iz.astype(jnp.uint32)


def sfc3d(x, y, z, box: Box, key_dtype, curve: str = HILBERT) -> jax.Array:
    """Float coordinates inside `box` -> SFC keys (sfc.hpp:187-194)."""
    ix, iy, iz = _grid_coords(x, y, z, box, key_dtype)
    return isfc_key(ix, iy, iz, key_dtype, curve)


def compute_sfc_keys(
    x, y, z, box: Box, key_dtype, curve: str = HILBERT, old_keys: jax.Array | None = None
) -> jax.Array:
    """Batch encode; particles flagged with removeKey keep their flag
    (sfc.hpp:283-292)."""
    keys = sfc3d(x, y, z, box, key_dtype, curve)
    if old_keys is not None:
        rk = remove_key(np.dtype(key_dtype))
        keys = jnp.where(old_keys == rk, old_keys, keys)
    return keys


def sfc_ibox(key_start: jax.Array, level, curve: str = HILBERT) -> IBox:
    """Integer coordinate box of the node starting at key_start
    (morton.hpp:177-184, hilbert.hpp:274-290)."""
    dt = key_start.dtype
    lmax = max_tree_level(dt)
    if curve == MORTON:
        ix, iy, iz = _morton.decode_morton(key_start)
        if isinstance(level, (int, np.integer)):
            cube = jnp.uint32(1 << (lmax - int(level)))
        else:
            cube = jnp.uint32(1) << (jnp.uint32(lmax) - level.astype(jnp.uint32))
        ix, iy, iz = ix.astype(jnp.int32), iy.astype(jnp.int32), iz.astype(jnp.int32)
        c = cube.astype(jnp.int32)
        return IBox(ix, ix + c, iy, iy + c, iz, iz + c)
    # Hilbert: decode, then round coordinates down to the node corner
    ix, iy, iz = _hilbert.decode_hilbert(key_start)
    if isinstance(level, (int, np.integer)):
        cube = jnp.uint32((1 << lmax) >> int(level))
    else:
        cube = jnp.uint32(1 << lmax) >> level.astype(jnp.uint32)
    mask = ~(cube - jnp.uint32(1))
    ix = (ix & mask).astype(jnp.int32)
    iy = (iy & mask).astype(jnp.int32)
    iz = (iz & mask).astype(jnp.int32)
    c = cube.astype(jnp.int32)
    return IBox(ix, ix + c, iy, iy + c, iz, iz + c)


def sfc_ibox_keys(key_start: jax.Array, key_end: jax.Array, curve: str = HILBERT) -> IBox:
    """Convenience overload taking [start, end) keys (sfc.hpp:226-231)."""
    return sfc_ibox(key_start, tree_level(key_end - key_start), curve)


def common_node_prefix(center, size, box: Box, key_dtype, curve: str = HILBERT) -> jax.Array:
    """Smallest placeholder-bit node containing the FP box (sfc.hpp:233-244).

    center, size: (..., 3) float arrays.
    """
    lower = sfc3d(
        center[..., 0] - size[..., 0],
        center[..., 1] - size[..., 1],
        center[..., 2] - size[..., 2],
        box,
        key_dtype,
        curve,
    )
    upper = sfc3d(
        center[..., 0] + size[..., 0],
        center[..., 1] + size[..., 1],
        center[..., 2] + size[..., 2],
        box,
        key_dtype,
        curve,
    )
    level = common_prefix(lower, upper) // 3
    node_key = enclosing_box_code(lower, level)
    return encode_placeholder_bit(node_key, 3 * level)


def sfc_neighbor(ibox: IBox, level, dx: int, dy: int, dz: int, key_dtype,
                 curve: str = HILBERT) -> jax.Array:
    """Smallest key in `ibox` shifted by (dx,dy,dz) box lengths, with PBC wrap
    (sfc.hpp:246-270)."""
    R = 1 << max_tree_level(key_dtype)
    shift = ibox.xmax - ibox.xmin
    x = pbc_adjust(ibox.xmin + dx * shift, R).astype(jnp.uint32)
    y = pbc_adjust(ibox.ymin + dy * shift, R).astype(jnp.uint32)
    z = pbc_adjust(ibox.zmin + dz * shift, R).astype(jnp.uint32)
    key = isfc_key(x, y, z, key_dtype, curve)
    return enclosing_box_code(key, level)
