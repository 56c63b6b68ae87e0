"""Coordinate bounding boxes with periodic-boundary support.

JAX re-design of the reference's Box/IBox (reference:
include/cstone/sfc/box.hpp). `Box` is a JAX pytree: its float limits are
traced leaves so per-step box updates never trigger recompilation, while
the boundary types are static aux data (they are simulation constants).
`IBox` carries integer octree coordinates as stacked arrays so that whole
batches of node boxes flow through overlap math at once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .keys import max_tree_level

__all__ = [
    "OPEN",
    "PERIODIC",
    "FIXED",
    "Box",
    "IBox",
    "make_box",
    "pbc_adjust",
    "pbc_distance",
    "apply_pbc",
    "put_in_box",
    "center_and_size",
    "create_fp_box",
    "create_ibox",
    "limit_box_shrinking",
]

# boundary types (box.hpp:97-102)
OPEN = 0
PERIODIC = 1
FIXED = 2


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Box:
    """Global coordinate bounding box (box.hpp:104-191).

    limits: (6,) array [xmin, xmax, ymin, ymax, zmin, zmax] — traced leaf.
    boundaries: tuple of 3 ints in {OPEN, PERIODIC, FIXED} — static.
    """

    limits: jax.Array
    boundaries: Tuple[int, int, int] = field(
        default=(OPEN, OPEN, OPEN), metadata=dict(static=True)
    )

    # --- accessors -------------------------------------------------------
    @property
    def xmin(self):
        return self.limits[0]

    @property
    def xmax(self):
        return self.limits[1]

    @property
    def ymin(self):
        return self.limits[2]

    @property
    def ymax(self):
        return self.limits[3]

    @property
    def zmin(self):
        return self.limits[4]

    @property
    def zmax(self):
        return self.limits[5]

    @property
    def mins(self):
        return self.limits[0::2]

    @property
    def maxs(self):
        return self.limits[1::2]

    @property
    def lengths(self):
        return self.maxs - self.mins

    @property
    def ilengths(self):
        return 1.0 / self.lengths

    @property
    def lx(self):
        return self.limits[1] - self.limits[0]

    @property
    def ly(self):
        return self.limits[3] - self.limits[2]

    @property
    def lz(self):
        return self.limits[5] - self.limits[4]

    @property
    def min_extent(self):
        return jnp.min(self.lengths)

    @property
    def max_extent(self):
        return jnp.max(self.lengths)

    @property
    def periodic_mask(self) -> np.ndarray:
        """Static (3,) bool mask of periodic dimensions."""
        return np.array([b == PERIODIC for b in self.boundaries])

    def __eq__(self, other):
        if not isinstance(other, Box):
            return NotImplemented
        return bool(jnp.all(self.limits == other.limits)) and self.boundaries == other.boundaries

    def __hash__(self):  # frozen dataclass needs it; limits excluded (traced)
        return hash(self.boundaries)


def make_box(
    xmin,
    xmax,
    ymin=None,
    ymax=None,
    zmin=None,
    zmax=None,
    boundaries=(OPEN, OPEN, OPEN),
    dtype=jnp.float32,
) -> Box:
    """Convenience constructor: cubic if only (xmin, xmax) given."""
    if ymin is None:
        ymin, ymax, zmin, zmax = xmin, xmax, xmin, xmax
    if isinstance(boundaries, int):
        boundaries = (boundaries, boundaries, boundaries)
    limits = jnp.asarray([xmin, xmax, ymin, ymax, zmin, zmax], dtype=dtype)
    return Box(limits=limits, boundaries=tuple(boundaries))


# ----------------------------------------------------------------------------
# integer boxes: batched struct-of-arrays
# ----------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class IBox:
    """Batch of integer octree-coordinate boxes (box.hpp:269-321).

    Each field may be scalar or (N,) int32. Bounds are [min, max) half-open
    in integer grid coordinates of [0, 2^maxLevel].
    """

    xmin: jax.Array
    xmax: jax.Array
    ymin: jax.Array
    ymax: jax.Array
    zmin: jax.Array
    zmax: jax.Array

    @staticmethod
    def of(xmin, xmax, ymin=None, ymax=None, zmin=None, zmax=None) -> "IBox":
        if ymin is None:
            ymin, ymax, zmin, zmax = xmin, xmax, xmin, xmax
        as_i32 = lambda v: jnp.asarray(v, dtype=jnp.int32)
        return IBox(as_i32(xmin), as_i32(xmax), as_i32(ymin), as_i32(ymax), as_i32(zmin), as_i32(zmax))

    @property
    def min_extent(self):
        return jnp.minimum(
            jnp.minimum(self.xmax - self.xmin, self.ymax - self.ymin), self.zmax - self.zmin
        )


# ----------------------------------------------------------------------------
# periodic arithmetic (box.hpp:59-95)
# ----------------------------------------------------------------------------

def pbc_adjust(x: jax.Array, R: int) -> jax.Array:
    """Map x in [-R, 2R) into [0, R)."""
    ret = jnp.where(x < 0, x + R, x)
    return jnp.where(ret >= R, ret - R, ret)


def pbc_distance(x: jax.Array, R: int) -> jax.Array:
    """Map x in [-R, R] into (-R/2, R/2]."""
    ret = jnp.where(x <= -R // 2, x + R, x)
    return jnp.where(ret > R // 2, ret - R, ret)


def apply_pbc(dX: jax.Array, box: Box) -> jax.Array:
    """Shortest periodic image of displacement dX, shape (..., 3) (box.hpp:194-206)."""
    pbc = jnp.asarray(box.periodic_mask, dtype=dX.dtype)
    L = box.lengths.astype(dX.dtype)
    iL = (1.0 / box.lengths).astype(dX.dtype)
    return dX - pbc * L * jnp.round(dX * iL)


def put_in_box(X: jax.Array, box: Box) -> jax.Array:
    """Fold positions (..., 3) into the box along periodic dimensions (box.hpp:209-231)."""
    pbc = box.periodic_mask
    mins = box.mins.astype(X.dtype)
    maxs = box.maxs.astype(X.dtype)
    L = box.lengths.astype(X.dtype)
    hi = X > maxs
    lo = X < mins
    shift = jnp.where(hi, -L, jnp.where(lo, L, jnp.zeros_like(X)))
    return X + jnp.asarray(pbc, dtype=X.dtype) * shift


# ----------------------------------------------------------------------------
# int <-> float box conversion (box.hpp:326-407)
# ----------------------------------------------------------------------------

def center_and_size(ibox: IBox, box: Box, key_dtype) -> Tuple[jax.Array, jax.Array]:
    """FP center and half-extent vectors of integer boxes (box.hpp:334-351).

    Returns (center, size) of shape (..., 3).
    """
    mc = max_tree_level(key_dtype)
    u_l = 1.0 / (1 << mc)
    fdt = box.limits.dtype
    half = (
        jnp.asarray(0.5, fdt) * jnp.asarray(u_l, fdt) * box.lengths
    )  # (3,) half unit-cell lengths

    imins = jnp.stack([ibox.xmin, ibox.ymin, ibox.zmin], axis=-1).astype(fdt)
    imaxs = jnp.stack([ibox.xmax, ibox.ymax, ibox.zmax], axis=-1).astype(fdt)

    center = box.mins + (imaxs + imins) * half
    size = (imaxs - imins) * half
    return center, size


def create_fp_box(ibox: IBox, box: Box, key_dtype) -> Tuple[jax.Array, jax.Array]:
    """FP (min, max) corners of integer boxes (box.hpp:361-370)."""
    center, size = center_and_size(ibox, box, key_dtype)
    return center - size, center + size


def create_ibox(center: jax.Array, size: jax.Array, box: Box, key_dtype) -> IBox:
    """Smallest IBox covering an FP box; inverts create_fp_box (box.hpp:381-407)."""
    mc = 1 << max_tree_level(key_dtype)
    xmin = center - size
    xmax = center + size
    iL = 1.0 / box.lengths
    nmin = (xmin - box.mins) * iL
    nmax = (xmax - box.mins) * iL
    imin = jnp.floor(nmin * mc).astype(jnp.int32)
    imax = jnp.ceil(nmax * mc).astype(jnp.int32)
    return IBox(
        imin[..., 0], imax[..., 0], imin[..., 1], imax[..., 1], imin[..., 2], imax[..., 2]
    )


def limit_box_shrinking(fitting: Box, previous: Box, shrink_limit: float = 0.05) -> Box:
    """Allow the box to shrink at most shrink_limit per side per step (box.hpp:414-431)."""
    L = previous.lengths
    lo_lim = previous.mins + shrink_limit * L
    hi_lim = previous.maxs - shrink_limit * L
    mins = jnp.minimum(fitting.mins, lo_lim)
    maxs = jnp.maximum(fitting.maxs, hi_lim)
    limits = jnp.stack([mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2]])
    return Box(limits=limits.astype(previous.limits.dtype), boundaries=previous.boundaries)
