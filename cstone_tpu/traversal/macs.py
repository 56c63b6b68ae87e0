"""Multipole acceptance criteria (MAC) evaluation and marking.

JAX re-design of the reference's MAC machinery (reference:
include/cstone/traversal/macs.hpp). Provides the min-distance and vector
MAC radii, PBC-aware evaluation, the commutative variants used by peer
discovery, and markMacs — flagging every tree node that fails the MAC
against any focus leaf — as one batched traversal.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..sfc.box import Box, apply_pbc, center_and_size
from ..sfc.encode import HILBERT, sfc_ibox
from ..sfc.keys import decode_prefix_length, max_tree_level, node_range, tree_level
from ..tree.octree import LinkedOctree, node_keys_and_levels
from .boxoverlap import min_distance_point_box
from .geometry import node_geometry
from .traversal import batched_mark

__all__ = [
    "inv_theta_min_mac",
    "inv_theta_vec_mac",
    "compute_min_mac_r2",
    "compute_vec_mac_r2",
    "evaluate_mac",
    "min_mac_mutual",
    "min_vec_mac_mutual",
    "mark_macs",
]


def inv_theta_min_mac(theta: float) -> float:
    """1/theta + 0.5 (macs.hpp:45)."""
    return 1.0 / theta + 0.5


def inv_theta_vec_mac(theta: float) -> float:
    """1/theta + sqrt(3) (macs.hpp:48)."""
    return 1.0 / theta + math.sqrt(3.0)


def compute_min_mac_r2(
    tree: LinkedOctree, inv_theta_eff: float, box: Box, curve: str = HILBERT
) -> jax.Array:
    """(cap_nodes, 4): geometric centers + squared min-MAC radius
    (macs.hpp:50-71)."""
    centers, sizes = node_geometry(tree, box, curve)
    l = 2.0 * jnp.max(sizes, axis=-1)
    mac = l * centers.dtype.type(inv_theta_eff)
    return jnp.concatenate([centers, (mac * mac)[:, None]], axis=-1)


def compute_vec_mac_r2(
    tree: LinkedOctree, exp_centers: jax.Array, inv_theta: float, box: Box,
    curve: str = HILBERT,
) -> jax.Array:
    """(cap_nodes,) squared vector-MAC radius per node (macs.hpp:73-97).

    exp_centers: (cap_nodes, 3) expansion (mass) centers.
    """
    centers, sizes = node_geometry(tree, box, curve)
    dx = exp_centers - centers
    s = jnp.sqrt(jnp.sum(dx * dx, axis=-1))
    l = 2.0 * jnp.max(sizes, axis=-1)
    mac = l * centers.dtype.type(inv_theta) + s
    return mac * mac


def evaluate_mac(
    source_center: jax.Array, mac_sq: jax.Array, target_center: jax.Array,
    target_size: jax.Array, box: Box | None = None,
) -> jax.Array:
    """True where the target box is within the acceptance radius
    (macs.hpp:99-141). Shapes broadcast on (..., 3)."""
    d = min_distance_point_box(source_center, target_center, target_size, box)
    r2 = jnp.sum(d * d, axis=-1)
    return r2 < jnp.abs(mac_sq)


def min_mac_mutual(center_a, size_a, center_b, size_b, box: Box, inv_theta: float) -> jax.Array:
    """Commutative min-distance MAC: True = pass = no interaction needed
    (macs.hpp:143-160)."""
    from .boxoverlap import min_distance_boxes

    d = min_distance_boxes(center_a, size_a, center_b, size_b, box)
    dist_sq = jnp.sum(d * d, axis=-1)
    size_ab = 2.0 * jnp.maximum(jnp.max(size_a, axis=-1), jnp.max(size_b, axis=-1))
    mac = size_ab * center_a.dtype.type(inv_theta)
    return dist_sq > mac * mac


def min_vec_mac_mutual(center_a, size_a, center_b, size_b, box: Box,
                       inv_theta_eff: float) -> jax.Array:
    """Commutative min+vector MAC combination (macs.hpp:162-193)."""
    fdt = center_a.dtype
    da = min_distance_point_box(center_b, center_a, size_a, box)
    mac_a = jnp.max(size_b, axis=-1) * fdt.type(2.0 * inv_theta_eff)
    pass_a = jnp.sum(da * da, axis=-1) > mac_a * mac_a

    db = min_distance_point_box(center_a, center_b, size_b, box)
    mac_b = jnp.max(size_a, axis=-1) * fdt.type(2.0 * inv_theta_eff)
    pass_b = jnp.sum(db * db, axis=-1) > mac_b * mac_b
    return pass_a & pass_b


def mark_macs(
    tree: LinkedOctree,
    centers: jax.Array,
    box: Box,
    focus_start,
    focus_end,
    focus_leaves: jax.Array,
    n_focus: jax.Array,
    limit_source: bool,
    curve: str = HILBERT,
) -> jax.Array:
    """Mark every node failing the MAC vs any focus leaf (macs.hpp:228-269).

    centers: (cap_nodes, 4) expansion centers + squared MAC radius.
    focus_leaves: (cap_focus+1,) cornerstone keys of the focus area.
    Returns (cap_nodes,) int32 marks over sorted node indices.
    """
    dt = tree.prefixes.dtype
    lmax = max_tree_level(dt)
    cap_focus = focus_leaves.shape[0] - 1

    # target geometry per focus leaf
    key = focus_leaves[:-1]
    rng = focus_leaves[1:] - key
    safe_rng = jnp.where(rng > 0, rng, node_range(dt, lmax))
    t_level = tree_level(safe_rng)
    t_ibox = sfc_ibox(key, t_level, curve)
    t_center, t_size = center_and_size(t_ibox, box, dt)

    q = jnp.arange(cap_focus, dtype=jnp.int32)
    # skip focus leaves whose 1-cell-extended box stays inside the focus:
    # cheap surface test (macs.hpp:258-261); conservative version: interior
    # test on integer coords against the focus range keys
    from ..sfc.encode import isfc_key  # placed here to avoid cycle
    from .boxoverlap import contained_in_keys
    from ..sfc.box import IBox as _IBox

    ext = _IBox(
        t_ibox.xmin - 1, t_ibox.xmax + 1, t_ibox.ymin - 1, t_ibox.ymax + 1,
        t_ibox.zmin - 1, t_ibox.zmax + 1,
    )
    interior = contained_in_keys(ext, focus_start, focus_end, dt, curve)
    active = (q < n_focus) & (~interior)

    if limit_source:
        max_level = jnp.maximum(t_level - 1, 0)
    else:
        max_level = jnp.full((cap_focus,), lmax, dtype=jnp.int32)

    node_start, node_end, node_level = node_keys_and_levels(tree)
    src_center = centers[:, :3]
    mac_sq = centers[:, 3]

    def criterion(q_ids, node_ids):
        contained = (node_start[node_ids] >= focus_start) & (node_end[node_ids] <= focus_end)
        violates = evaluate_mac(
            src_center[node_ids], mac_sq[node_ids], t_center[q_ids], t_size[q_ids], box
        )
        level_ok = node_level[node_ids] <= max_level[q_ids]
        return (~contained) & violates & level_ok

    return batched_mark(
        tree.child_offsets, criterion, cap_focus, mark_endpoints_only=False,
        active_mask=active,
    )
