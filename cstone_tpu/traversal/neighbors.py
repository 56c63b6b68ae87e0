"""Fixed-radius neighbor search over the linked octree.

Re-design of the reference's neighbor search (reference:
include/cstone/findneighbors.hpp:80-188 for semantics, and the GPU
warp-BFS kernel traversal/find_neighbors.cuh:200-506 for the structure).

Like the reference GPU kernel, targets are processed in groups of
spatially-compact, SFC-consecutive particles: one tree traversal per
*group* (bounding box dilated by the group's max search radius) collects
candidate leaf cells; the group's particles are then tested all-pairs
against the candidates — an operation that is dense and regular.
Semantics match findNeighbors exactly: a neighbor of i
is any j != i with dist^2(i,j) < (2*h_i)^2 (PBC-aware); returned counts
include neighbors beyond ng_max, while index lists are capped at ng_max
(findneighbors.hpp:111-158).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..tree.octree import LinkedOctree
from .boxoverlap import min_distance_boxes
from .geometry import node_geometry
from .traversal import batched_collect_leaves_bfs

__all__ = ["OctreeNsView", "NbStats", "make_ns_view", "find_neighbors"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NbStats:
    """Neighbor-search diagnostics, the analog of the reference's NcStats
    (reference: traversal/find_neighbors.cuh:346-357). All values are maxima
    over target groups; overflow is signalled by a value exceeding its cap.
    """

    leaf_max: jax.Array  # candidate leaves per group (cap: cand_leaf_cap)
    frontier_max: jax.Array  # BFS frontier width (cap: frontier_cap)
    cand_max: jax.Array  # flattened candidates per group (cap: cand_cap)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class OctreeNsView:
    """Octree data needed for neighbor search (octree.hpp:295-317)."""

    tree: LinkedOctree
    layout: jax.Array  # (cap_leaf+1,) particle offsets per leaf
    centers: jax.Array  # (cap_nodes, 3)
    sizes: jax.Array  # (cap_nodes, 3)
    search_ext_factor: float = field(default=1.0, metadata=dict(static=True))


def make_ns_view(
    tree: LinkedOctree,
    layout: jax.Array,
    box: Box,
    curve: str = HILBERT,
    search_ext_factor: float = 1.0,
) -> OctreeNsView:
    centers, sizes = node_geometry(tree, box, curve)
    return OctreeNsView(
        tree=tree,
        layout=layout,
        centers=centers,
        sizes=sizes,
        search_ext_factor=search_ext_factor,
    )


def _group_reduce(arr: jax.Array, n: int, group_size: int, n_groups: int, fill, op):
    """Reshape (n_pad,) particle data to (n_groups, group_size) with fill."""
    pad = n_groups * group_size - arr.shape[0]
    if pad > 0:
        arr = jnp.concatenate([arr, jnp.full((pad,), fill, arr.dtype)])
    return arr.reshape(n_groups, group_size)


@partial(
    jax.jit,
    static_argnames=(
        "ng_max",
        "group_size",
        "cand_leaf_cap",
        "cand_cap",
        "chunk",
        "with_indices",
        "n_targets",
        "frontier_cap",
    ),
)
def _find_neighbors_impl(
    x,
    y,
    z,
    h,
    view: OctreeNsView,
    box: Box,
    ng_max: int,
    group_size: int,
    cand_leaf_cap: int,
    cand_cap: int,
    chunk: int,
    with_indices: bool,
    n_targets: int,
    frontier_cap: int = 64,
):
    n = n_targets
    fdt = x.dtype
    n_groups = -(-n // group_size)
    cap_nodes = view.centers.shape[0]

    # ---- group bounding boxes + max radii ---------------------------------
    big = fdt.type(np.finfo(fdt).max)
    gx = _group_reduce(x[:n], n, group_size, n_groups, 0, None)
    gy = _group_reduce(y[:n], n, group_size, n_groups, 0, None)
    gz = _group_reduce(z[:n], n, group_size, n_groups, 0, None)
    gh = _group_reduce(h[:n], n, group_size, n_groups, 0, None)
    lane = jnp.arange(group_size, dtype=jnp.int32)
    gvalid = (jnp.arange(n_groups, dtype=jnp.int32)[:, None] * group_size + lane[None, :]) < n

    def vmin(a):
        return jnp.min(jnp.where(gvalid, a, big), axis=1)

    def vmax(a):
        return jnp.max(jnp.where(gvalid, a, -big), axis=1)

    gmin = jnp.stack([vmin(gx), vmin(gy), vmin(gz)], axis=-1)  # (n_groups, 3)
    gmax = jnp.stack([vmax(gx), vmax(gy), vmax(gz)], axis=-1)
    g_center = (gmin + gmax) * fdt.type(0.5)
    g_size = (gmax - gmin) * fdt.type(0.5)
    g_radius = fdt.type(2.0 * view.search_ext_factor) * vmax(gh)  # (n_groups,)

    any_pbc = any(b == 1 for b in box.boundaries)

    # ---- traversal: candidate leaf cells per group -------------------------
    def criterion(q_ids, node_ids):
        nc = view.centers[node_ids]
        ns = view.sizes[node_ids]
        d = min_distance_boxes(
            g_center[q_ids], g_size[q_ids], nc, ns, box if any_pbc else None
        )
        d2 = jnp.sum(d * d, axis=-1)
        return d2 < (g_radius[q_ids] * g_radius[q_ids])

    leaves_sorted, n_cand_leaves, fmax = batched_collect_leaves_bfs(
        view.tree.child_offsets, criterion, n_groups, cand_leaf_cap, frontier_cap
    )
    # convert sorted node index -> cornerstone leaf index for layout lookup
    leaf_idx = view.tree.internal_to_leaf[jnp.maximum(leaves_sorted, 0)]
    leaf_idx = jnp.where(leaves_sorted >= 0, leaf_idx, 0)

    leaf_max = jnp.max(n_cand_leaves).astype(jnp.int32)
    frontier_max = jnp.max(fmax).astype(jnp.int32)

    # ---- flatten candidate particle ranges per group ----------------------
    # segment fill via scatter + cumulative max instead of per-slot binary
    # search (the searchsorted formulation costs ~8 serial gathers per slot)
    k = jnp.arange(cand_leaf_cap, dtype=jnp.int32)
    k_valid = k[None, :] < jnp.minimum(n_cand_leaves, cand_leaf_cap)[:, None]
    starts = view.layout[leaf_idx]
    lens = jnp.where(k_valid, view.layout[leaf_idx + 1] - starts, 0)
    inc = jnp.cumsum(lens, axis=1)
    total_cand = inc[:, -1]
    exc_k = inc - lens  # exclusive offsets per (group, leaf slot)

    row_q = jnp.arange(n_groups, dtype=jnp.int32)[:, None]
    seg0 = jnp.zeros((n_groups, cand_cap), dtype=jnp.int32)
    scatter_ok = k_valid & (lens > 0) & (exc_k < cand_cap)
    seg0 = seg0.at[
        jnp.where(scatter_ok, row_q, n_groups),
        jnp.where(scatter_ok, exc_k, 0),
    ].max(jnp.broadcast_to(k[None, :], exc_k.shape), mode="drop")
    seg = jax.lax.cummax(seg0, axis=1)

    j = jnp.arange(cand_cap, dtype=jnp.int32)
    exc = exc_k[row_q, seg]
    cand_idx = starts[row_q, seg] + (j[None, :] - exc)
    cand_valid = j[None, :] < jnp.minimum(total_cand, cand_cap)[:, None]
    cand_idx = jnp.where(cand_valid, cand_idx, 0)

    # ---- all-pairs distance tests -------------------------------------------
    n_chunks = -(-n_groups // chunk)
    pad_groups = n_chunks * chunk

    def pad_rows(a, fill=0):
        p = pad_groups - a.shape[0]
        if p > 0:
            a = jnp.concatenate([a, jnp.full((p,) + a.shape[1:], fill, a.dtype)])
        return a

    cand_idx_p = pad_rows(cand_idx)
    cand_valid_p = pad_rows(cand_valid.astype(jnp.bool_))
    gx_p, gy_p, gz_p, gh_p = map(pad_rows, (gx, gy, gz, gh))
    gvalid_p = pad_rows(gvalid.astype(jnp.bool_))

    pbc_mask = jnp.asarray(box.periodic_mask, dtype=fdt)
    L = box.lengths.astype(fdt)
    iL = (1.0 / box.lengths).astype(fdt)

    def do_chunk(c):
        s = c * chunk
        ci = jax.lax.dynamic_slice_in_dim(cand_idx_p, s, chunk)
        cv = jax.lax.dynamic_slice_in_dim(cand_valid_p, s, chunk)
        txs = jax.lax.dynamic_slice_in_dim(gx_p, s, chunk)
        tys = jax.lax.dynamic_slice_in_dim(gy_p, s, chunk)
        tzs = jax.lax.dynamic_slice_in_dim(gz_p, s, chunk)
        ths = jax.lax.dynamic_slice_in_dim(gh_p, s, chunk)
        tv = jax.lax.dynamic_slice_in_dim(gvalid_p, s, chunk)

        cxs, cys, czs = x[ci], y[ci], z[ci]  # (chunk, cand_cap)

        def axis_d(t, cnd, dim):
            d = t[:, :, None] - cnd[:, None, :]
            if any_pbc:
                d = d - pbc_mask[dim] * L[dim] * jnp.round(d * iL[dim])
            return d

        dx = axis_d(txs, cxs, 0)
        dy = axis_d(tys, cys, 1)
        dz = axis_d(tzs, czs, 2)
        d2 = dx * dx + dy * dy + dz * dz  # (chunk, G, cand_cap)

        r2 = (fdt.type(2.0) * ths) ** 2  # (chunk, G)
        tgt_idx = (
            (jnp.arange(chunk, dtype=jnp.int32)[:, None] + s) * group_size
            + lane[None, :]
        )  # (chunk, G) global particle ids
        not_self = ci[:, None, :] != tgt_idx[:, :, None]
        within = (
            (d2 < r2[:, :, None]) & not_self & cv[:, None, :] & tv[:, :, None]
        )

        cnt = jnp.sum(within, axis=-1, dtype=jnp.uint32)  # (chunk, G)
        if with_indices:
            rank = jnp.cumsum(within, axis=-1) - within.astype(jnp.int32)
            nb = jnp.full((chunk, group_size, ng_max), -1, dtype=jnp.int32)
            ok = within & (rank < ng_max)
            b_ids = jnp.broadcast_to(
                jnp.arange(chunk, dtype=jnp.int32)[:, None, None], within.shape
            )
            g_ids = jnp.broadcast_to(lane[None, :, None], within.shape)
            nb = nb.at[
                jnp.where(ok, b_ids, chunk),
                jnp.where(ok, g_ids, 0),
                jnp.where(ok, rank, 0),
            ].set(jnp.broadcast_to(ci[:, None, :], within.shape), mode="drop")
            return cnt, nb
        return cnt, jnp.zeros((chunk, group_size, 0), dtype=jnp.int32)

    counts, nbs = jax.lax.map(do_chunk, jnp.arange(n_chunks, dtype=jnp.int32))
    counts = counts.reshape(pad_groups * group_size)[: x.shape[0]]
    stats = NbStats(
        leaf_max=leaf_max,
        frontier_max=frontier_max,
        cand_max=jnp.max(total_cand).astype(jnp.int32),
    )
    if with_indices:
        nbs = nbs.reshape(pad_groups * group_size, ng_max)[: x.shape[0]]
        return counts, nbs, stats
    return counts, None, stats


def check_nb_stats(
    stats: NbStats,
    cand_leaf_cap: int,
    frontier_cap: int,
    cand_cap: int,
) -> None:
    """Raise if any capacity in the neighbor pass overflowed (results would
    be silently incomplete otherwise)."""
    if int(stats.leaf_max) > cand_leaf_cap:
        raise RuntimeError(
            f"candidate leaf capacity {cand_leaf_cap} exceeded "
            f"(needed {int(stats.leaf_max)}); raise cand_leaf_cap"
        )
    if int(stats.frontier_max) > frontier_cap:
        raise RuntimeError(
            f"traversal frontier capacity {frontier_cap} exceeded "
            f"(needed {int(stats.frontier_max)}); raise frontier_cap"
        )
    if int(stats.cand_max) > cand_cap:
        raise RuntimeError(
            f"candidate capacity {cand_cap} exceeded "
            f"(needed {int(stats.cand_max)}); raise cand_cap"
        )


def find_neighbors(
    x: jax.Array,
    y: jax.Array,
    z: jax.Array,
    h: jax.Array,
    view: OctreeNsView,
    box: Box,
    ng_max: int = 256,
    group_size: int = 64,
    cand_leaf_cap: int = 128,
    cand_cap: int = 2048,
    chunk: int = 32,
    with_indices: bool = False,
    n_targets: Optional[int] = None,
    frontier_cap: int = 64,
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Neighbor counts (and optionally indices) for SFC-ordered particles.

    Semantics per findneighbors.hpp:95-165; counts may exceed ng_max,
    indices are capped at ng_max and padded with -1.
    """
    n = int(x.shape[0]) if n_targets is None else int(n_targets)
    counts, nbs, stats = _find_neighbors_impl(
        x, y, z, h, view, box,
        int(ng_max), int(group_size), int(cand_leaf_cap), int(cand_cap), int(chunk),
        bool(with_indices), n, frontier_cap=int(frontier_cap),
    )
    check_nb_stats(stats, cand_leaf_cap, frontier_cap, cand_cap)
    return counts, nbs
