"""Closed-form SFC-grid candidate cover for neighbor search.

Dense replacement for the per-group tree traversal of the neighbor
pipeline. The reference walks the octree per target group to collect
candidate leaf cells (reference: traversal/find_neighbors.cuh:200-343,
findneighbors.hpp:96-165); a tree walk is irregular, gather-bound work.
This module instead exploits two facts:

  1. particles are SFC-sorted, so ANY key interval is a contiguous
     particle-index run — no tree needed to map cells to particles;
  2. the cells of a regular grid at any level that overlap an axis-
     aligned box are enumerable in closed form from the box's integer
     corner coordinates — no tree needed to enumerate candidates.

For each target group: dilate its bounding box by the group's max search
radius, pick the coarsest grid level at which the box spans at most
`cells_per_dim` cells per dimension (adaptive: spatially small groups get
fine cells), enumerate the <= cells_per_dim^3 cells, encode each cell
corner to its SFC key, and look the key interval up in a precomputed
per-cell particle-offset table. Sorting the per-group cell intervals and
merging adjacent ones yields the same contiguous candidate runs the tree
traversal produced — as dense vectorized integer math.

The cover is a superset of the dilated box (cells are grid-aligned), so
downstream distance tests give exactly the findNeighbors semantics; the
per-group level adapts to local density exactly like tree depth does.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.bits import bit_width
from ..sfc.box import Box
from ..sfc.encode import HILBERT, isfc_key_top
from ..sfc.keys import max_tree_level

__all__ = ["build_cell_table", "group_cover_runs"]


def build_cell_table(
    keys: jax.Array, table_level: int, n_valid=None
) -> jax.Array:
    """Particle-offset table over the regular grid at `table_level`.

    keys: (n,) SFC-sorted particle keys (padding must be removeKey, which
    exceeds every valid key). Returns offsets (8^table_level + 1,) int32:
    particles of cell c occupy [table[c], table[c+1]) in the sorted order.
    """
    dt = keys.dtype
    L = max_tree_level(dt)
    shift = dt.type(3 * (L - table_level))
    n_cells = 1 << (3 * table_level)
    idx = jnp.minimum((keys >> shift).astype(jnp.int32), jnp.int32(n_cells))
    if n_valid is not None:
        slot = jnp.arange(keys.shape[0], dtype=jnp.int32)
        idx = jnp.where(slot < jnp.asarray(n_valid, jnp.int32), idx, n_cells)
    counts = jnp.zeros((n_cells + 1,), jnp.int32).at[idx].add(1)
    return jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts[:n_cells])]
    )


def _merge_sorted_intervals(
    pstart: jax.Array, pend: jax.Array, run_cap: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Merge per-group disjoint intervals, sorted by pstart, into runs.

    pstart/pend: (n_groups, K) int32; invalid slots must carry
    pstart == pend == INT32_MAX (they sort last and merge to nothing).
    Returns (run_start (n_groups, run_cap), run_len, n_runs).
    """
    n_groups, K = pstart.shape
    nonempty = pend > pstart
    # carry the last nonempty end across empty slots
    k = jnp.arange(K, dtype=jnp.int32)
    tag = jnp.where(nonempty, k, -1)
    last_ne = jax.lax.cummax(tag, axis=1)
    prev_tag = jnp.concatenate(
        [jnp.full((n_groups, 1), -1, jnp.int32), last_ne[:, :-1]], axis=1
    )
    prev_end = jnp.where(
        prev_tag >= 0,
        jnp.take_along_axis(pend, jnp.maximum(prev_tag, 0), axis=1),
        -1,
    )
    new_run = nonempty & (pstart > prev_end)
    run_id = jnp.cumsum(new_run.astype(jnp.int32), axis=1) - 1
    n_runs = jnp.max(jnp.where(nonempty, run_id + 1, 0), axis=1)

    rows = jnp.arange(n_groups, dtype=jnp.int32)[:, None]
    ok_s = new_run & (run_id < run_cap)
    run_start = jnp.zeros((n_groups, run_cap), jnp.int32)
    run_start = run_start.at[
        jnp.where(ok_s, rows, n_groups), jnp.where(ok_s, run_id, 0)
    ].set(pstart, mode="drop")
    ok_e = nonempty & (run_id < run_cap)
    run_end = jnp.zeros((n_groups, run_cap), jnp.int32)
    run_end = run_end.at[
        jnp.where(ok_e, rows, n_groups), jnp.where(ok_e, run_id, 0)
    ].max(pend, mode="drop")
    run_len = jnp.maximum(run_end - run_start, 0)
    return run_start, run_len, n_runs


def group_cover_runs(
    gmin: jax.Array,  # (n_groups, 3) group bbox minima
    gmax: jax.Array,  # (n_groups, 3) group bbox maxima
    g_radius: jax.Array,  # (n_groups,) dilation radius (2*h_max*ext)
    table: jax.Array,  # (8^table_level + 1,) from build_cell_table
    table_level: int,
    box: Box,
    key_dtype,
    curve: str = HILBERT,
    cells_per_dim: int = 8,
    run_cap: int = 64,
    active: jax.Array | None = None,  # (n_groups,) bool; inactive -> no runs
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Contiguous candidate particle runs per group via grid cover.

    Returns (run_start (n_groups, run_cap) int32, run_len, n_runs,
    overflow bool — True if any group needed more than run_cap runs).
    """
    dt = np.dtype(key_dtype)
    L = max_tree_level(dt)
    C = int(cells_per_dim)
    assert C >= 3, "cells_per_dim >= 3"
    n_groups = gmin.shape[0]
    fdt = gmin.dtype

    # ---- integer dilated bounds (unclamped; int32 holds +-2^21 easily) ----
    m = (fdt.type(1 << L) / box.lengths.astype(fdt))  # (3,)
    mins = box.mins.astype(fdt)
    lo = gmin - g_radius[:, None]
    hi = gmax + g_radius[:, None]
    imin = jnp.floor((lo - mins[None, :]) * m[None, :]).astype(jnp.int32)
    imax = jnp.floor((hi - mins[None, :]) * m[None, :]).astype(jnp.int32)
    mcoord = jnp.int32((1 << L) - 1)
    periodic = jnp.asarray(
        [b == 1 for b in box.boundaries], dtype=bool
    )  # (3,)
    # non-periodic dims: nothing exists outside the box
    imin = jnp.where(periodic[None, :], imin, jnp.clip(imin, 0, mcoord))
    imax = jnp.where(periodic[None, :], imax, jnp.clip(imax, 0, mcoord))

    # ---- per-group level: coarsest with span <= C cells per dim ----------
    # span(s) = (imax>>s) - (imin>>s) + 1 <= floor(ext/2^s) + 2, so
    # s = bit_width(ext // (C-1)) guarantees ext>>s <= C-2, span <= C.
    ext = imax - imin  # >= 0
    s_d = bit_width((ext // jnp.int32(C - 1)).astype(jnp.uint32)).astype(jnp.int32)
    s = jnp.max(s_d, axis=1)  # (n_groups,)
    s = jnp.maximum(s, jnp.int32(L - int(table_level)))  # table resolution floor
    s = jnp.minimum(s, jnp.int32(L))
    lvl = jnp.int32(L) - s

    base = imin >> s[:, None]  # (n_groups, 3) cell coords at level lvl
    count = (imax >> s[:, None]) - base + 1  # (n_groups, 3), <= C
    n_side = jnp.int32(1) << lvl  # cells per dim at this level
    count = jnp.minimum(count, n_side[:, None])  # periodic full wrap guard

    # ---- enumerate the C^3 cell block ------------------------------------
    j = jnp.arange(C, dtype=jnp.int32)
    # (n_groups, C) per-dim cell coords, wrapped or clamped
    def cell_coords(d):
        c = base[:, d, None] + j[None, :]
        wrapped = jnp.where(
            periodic[d], c & (n_side[:, None] - 1), jnp.clip(c, 0, mcoord)
        )
        valid = j[None, :] < count[:, d, None]
        return wrapped, valid

    cx, vx = cell_coords(0)
    cy, vy = cell_coords(1)
    cz, vz = cell_coords(2)
    # full-resolution corner coordinates of each cell: coord << s
    fx = (cx.astype(jnp.uint32) << s[:, None].astype(jnp.uint32))
    fy = (cy.astype(jnp.uint32) << s[:, None].astype(jnp.uint32))
    fz = (cz.astype(jnp.uint32) << s[:, None].astype(jnp.uint32))

    K = C * C * C
    gx = jnp.broadcast_to(fx[:, :, None, None], (n_groups, C, C, C)).reshape(n_groups, K)
    gy = jnp.broadcast_to(fy[:, None, :, None], (n_groups, C, C, C)).reshape(n_groups, K)
    gz = jnp.broadcast_to(fz[:, None, None, :], (n_groups, C, C, C)).reshape(n_groups, K)
    valid = (
        jnp.broadcast_to(vx[:, :, None, None], (n_groups, C, C, C))
        & jnp.broadcast_to(vy[:, None, :, None], (n_groups, C, C, C))
        & jnp.broadcast_to(vz[:, None, None, :], (n_groups, C, C, C))
    ).reshape(n_groups, K)
    if active is not None:
        valid = valid & active[:, None]

    # cell corner keys at table_level resolution: only the top
    # 3*table_level key bits are needed for the table lookup, so run just
    # `table_level` encode rounds in u32 instead of a full-depth (u64)
    # encode — the dominant cost of this stage at 64-bit keys
    tstart = isfc_key_top(gx, gy, gz, int(table_level), L, curve).astype(jnp.int32)

    # ---- table lookup: cell -> particle interval --------------------------
    # cell spans 8^(table_level - lvl) table slots; aligned by construction
    tlen = jnp.int32(1) << (jnp.int32(3) * (jnp.int32(table_level) - lvl))
    tstart = tstart & ~(tlen[:, None] - 1)  # corner key low bits are zero anyway
    pstart = table[tstart]
    pend = table[tstart + tlen[:, None]]
    sentinel = jnp.int32(np.iinfo(np.int32).max)
    pstart = jnp.where(valid, pstart, sentinel)
    pend = jnp.where(valid, pend, sentinel)

    # ---- sort by pstart and merge adjacent intervals ----------------------
    pstart_s, pend_s = jax.lax.sort((pstart, pend), dimension=1, num_keys=1)
    run_start, run_len, n_runs = _merge_sorted_intervals(pstart_s, pend_s, run_cap)
    overflow = jnp.max(n_runs) > run_cap
    return run_start, run_len, n_runs, overflow
