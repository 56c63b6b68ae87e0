"""Source (mass) centers per octree node.

JAX re-design of the reference's source centers (reference:
include/cstone/focus/source_center.hpp + source_center_gpu.cu). Leaf mass
centers come from one segment-sum over SFC-sorted particles; the upsweep
is the generic level-by-level combine. A center is a (x, y, z, m) Vec4;
set_mac_radii replaces m with the squared vector-MAC radius
(source_center.hpp:128-142).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.primitives import segment_ids_from_offsets
from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..traversal.geometry import node_geometry
from ..tree.octree import LinkedOctree, upsweep

__all__ = [
    "compute_leaf_source_centers",
    "combine_source_centers",
    "upsweep_centers",
    "set_mac_radii",
    "geo_mac_spheres",
]


def compute_leaf_source_centers(
    x: jax.Array, y: jax.Array, z: jax.Array, m: jax.Array, layout: jax.Array,
    cap_leaf: int,
) -> jax.Array:
    """(cap_leaf, 4) leaf mass centers (source_center.hpp:68-126).

    layout: (cap_leaf+1,) particle offsets per leaf; particles SFC-sorted.
    """
    n = x.shape[0]
    seg_id = segment_ids_from_offsets(layout, n, cap_leaf)
    w = jnp.abs(m)
    sums = jnp.stack([w * x, w * y, w * z, w], axis=-1)
    per_leaf = jax.ops.segment_sum(
        sums, seg_id, num_segments=cap_leaf, indices_are_sorted=True
    )
    return _normalize_mass(per_leaf)


def _normalize_mass(centers: jax.Array) -> jax.Array:
    mass = centers[..., 3:4]
    inv = jnp.where(mass != 0, 1.0 / jnp.where(mass != 0, mass, 1.0), 1.0)
    return jnp.concatenate([centers[..., :3] * inv, mass], axis=-1)


def combine_source_centers(_, children: jax.Array) -> jax.Array:
    """Upsweep combine: mass-weighted mean of 8 child centers
    (source_center.hpp:82-97). children: (n, 8, 4)."""
    w = jnp.abs(children[..., 3:4])
    acc = jnp.sum(
        jnp.concatenate([children[..., :3] * w, w], axis=-1), axis=-2
    )
    return _normalize_mass(acc)


def upsweep_centers(tree: LinkedOctree, leaf_centers: jax.Array) -> jax.Array:
    """(cap_nodes, 4) node mass centers from leaf centers."""
    return upsweep(tree, leaf_centers, combine_source_centers)


def set_mac_radii(
    tree: LinkedOctree, centers: jax.Array, inv_theta: float, box: Box,
    curve: str = HILBERT,
) -> jax.Array:
    """Replace center[3] by the squared vector-MAC radius; zero-mass nodes
    stay 0 (source_center.hpp:128-142)."""
    from ..traversal.macs import compute_vec_mac_r2

    mac2 = compute_vec_mac_r2(tree, centers[:, :3], inv_theta, box, curve)
    m = centers[:, 3]
    new_last = jnp.where(m != 0, mac2, 0.0).astype(centers.dtype)
    return jnp.concatenate([centers[:, :3], new_last[:, None]], axis=-1)


def geo_mac_spheres(
    tree: LinkedOctree, inv_theta: float, box: Box, curve: str = HILBERT
) -> jax.Array:
    """(cap_nodes, 4) geometric centers + min-MAC radius squared
    (source_center.hpp:159-168)."""
    from ..traversal.macs import compute_min_mac_r2

    return compute_min_mac_r2(tree, inv_theta, box, curve)
