"""Tiered cell-list for density-adaptive smoothing lengths.

The single-level cell list (celllist.py) requires one grid level whose
cell side covers 2*max(h) — on clustered inputs (SPH's regime, reference
traversal/find_neighbors.cuh:46-75) that level is so coarse the dense core
overflows any ELL capacity. This module decomposes the search by h-tier:

  1. particles are assigned the FINEST listed grid level still admissible
     for their radius (cell side >= 2h) and partitioned by (tier, key) —
     one extra sort; within a tier the particles stay SFC-contiguous;
  2. same-tier pairs run the 27-point stencil at the tier's own
     level, where occupancy is bounded by the local neighbor count
     (h ~ interparticle spacing, so a 2h-wide cell holds O(nu) of its own
     tier regardless of absolute density);
  3. cross-tier pairs run two passes per tier pair at the COARSER level
     (whose cell side covers both radii): the coarse tier's targets
     against the fine tier's candidates, and the other way round.

Every pass is the same 27-point stencil (celllist.choose_stencil); per-pass
ELL capacities are independent, so the core's density only sizes the fine
tiers. Exact: every ordered pair with d < 2*h_i lands in exactly one pass
whose grid covers the radius. This is the dense-grid form of the regime
the reference handles with per-warp tree opening
(find_neighbors.cuh:200-343).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..sfc.keys import max_tree_level
from .celllist import _stencil, ell_pack_gather, rowmajor_cell_perm

__all__ = [
    "choose_tier_levels",
    "tier_caps",
    "cell_list_neighbor_counts_tiered",
]


def _tier_index(hs: jax.Array, box: Box, levels: Sequence[int]) -> jax.Array:
    """(n,) int32 tier per particle: the FINEST listed level with cell
    side >= 2h on every dim. levels must be ascending; levels[0] must be
    admissible for max(h) (choose_cell_level guarantees it)."""
    min_side = jnp.min(box.lengths).astype(jnp.float32)
    tier = jnp.zeros(hs.shape, jnp.int32)
    for j, lvl in enumerate(levels[1:], start=1):
        adm = (min_side / np.float32(1 << lvl)) >= 2.0 * hs
        tier = jnp.where(adm, j, tier)
    return tier


def choose_tier_levels(
    hs: np.ndarray, box_min_side: float, max_tiers: int = 3,
    max_level: int = 7,
) -> Tuple[int, ...]:
    """Host-side: pick up to max_tiers ascending grid levels spanning the
    h distribution — coarsest from max(h), finest from the lower h bulk
    (5th percentile), one level per octave in between."""
    h = np.asarray(hs, np.float64)
    lo = int(np.floor(np.log2(box_min_side / (2.0 * float(h.max())))))
    if lo < 2:
        # level 2 is the coarsest the 27-stencil supports (>=3 distinct
        # cells per periodic dim); a larger max(h) has no admissible tier
        # and would silently undercount — callers must fall back to a
        # dense path (same contract as choose_cell_level)
        raise ValueError(
            f"max(h)={float(h.max()):.4g} needs a grid coarser than level 2 "
            f"(box side {box_min_side:.4g}); no admissible tier — use a "
            "dense/tree path instead"
        )
    lo = min(lo, max_level)  # uniformly small h: single finest tier
    lvl_hi = int(np.floor(np.log2(box_min_side / (2.0 * float(np.quantile(h, 0.05))))))
    hi = min(max_level, max(lo, lvl_hi))
    levels = list(range(lo, hi + 1))
    if len(levels) > max_tiers:
        # keep the coarsest + the finest (max_tiers-1): coarse tiers are
        # cheap (few particles), fine tiers bound the core occupancy
        levels = [levels[0]] + levels[-(max_tiers - 1):]
    return tuple(levels)


def tier_caps(
    pos: np.ndarray, hs: np.ndarray, box_limits, levels: Sequence[int],
    slack: float = 1.15,
) -> Tuple[Tuple[int, ...], Dict[Tuple[int, int], int]]:
    """Host-side capacity sizing from measured occupancy: per-tier cap at
    its own level, and per (a, b) pair the tier-b candidate cap at
    level_a. Multiples of 8."""
    xmin, xmax = float(box_limits[0]), float(box_limits[1])
    span = xmax - xmin
    min_side = span  # cubic box assumed for sizing (caps only need bounds)
    lvl_adm = np.floor(np.log2(min_side / (2.0 * np.asarray(hs, np.float64))))
    tier = np.zeros(len(hs), np.int64)
    for j, lvl in enumerate(levels[1:], start=1):
        tier[lvl_adm >= lvl] = j

    def occ_max(mask, level):
        d = 1 << level
        if not mask.any():
            return 0
        ijk = np.clip(((pos[mask] - xmin) / span * d).astype(np.int64), 0, d - 1)
        flat = (ijk[:, 0] * d + ijk[:, 1]) * d + ijk[:, 2]
        return int(np.bincount(flat, minlength=d * d * d).max())

    def rcap(m):
        return max(8, int(-(-int(m * slack + 8) // 8) * 8))

    T = len(levels)
    same = tuple(rcap(occ_max(tier == t, levels[t])) for t in range(T))
    cross = {}
    for a in range(T):
        for b in range(a + 1, T):
            cross[(a, b)] = rcap(occ_max(tier == b, levels[a]))
    return same, cross


def cell_list_neighbor_counts_tiered(
    keys_sorted: jax.Array,  # (n,) SFC-sorted particle keys
    xs: jax.Array,
    ys: jax.Array,
    zs: jax.Array,
    hs: jax.Array,  # (n,) per-particle interaction radii
    box: Box,
    levels: Tuple[int, ...],  # ascending grid levels (static)
    caps: Tuple[int, ...],  # per-tier ELL cap at its own level (static)
    cross_caps: Dict[Tuple[int, int], int],  # (a,b)->tier-b cap at level_a
    curve: str = HILBERT,
    n_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """(n,) exact neighbor counts in input (key-sorted) order + overflow."""
    stencil = _stencil()
    n = keys_sorted.shape[0]
    dt = keys_sorted.dtype
    L = max_tree_level(dt)
    T = len(levels)
    periodic = tuple(int(b) == 1 for b in box.boundaries)

    tier = _tier_index(hs, box, levels)
    if n_valid is not None:
        pos_i = jnp.arange(n, dtype=jnp.int32)
        tier = jnp.where(pos_i < jnp.asarray(n_valid, jnp.int32), tier, T)
    orig = jnp.arange(n, dtype=jnp.int32)
    # partition by (tier, key): tiers contiguous, SFC order kept within
    tier_s, keys_s, xs_s, ys_s, zs_s, hs_s, orig_s = jax.lax.sort(
        (tier, keys_sorted, xs, ys, zs, hs, orig), num_keys=2, is_stable=True
    )

    def cells_for(t, level):
        n_cells = 1 << (3 * level)
        shift = dt.type(3 * (L - level))
        cell = jnp.minimum(keys_s >> shift, dt.type(n_cells)).astype(jnp.int32)
        return jnp.where(
            tier_s < t, jnp.int32(-1),
            jnp.where(tier_s > t, jnp.int32(n_cells), cell),
        )

    def pack(t, level, cap):
        perm, _ = rowmajor_cell_perm(level, curve)
        (px, py, pz, ph), valid, pidx, ovf = ell_pack_gather(
            keys_s, perm, (xs_s, ys_s, zs_s, hs_s), cap, level,
            cell_override=cells_for(t, level),
        )
        r2 = jnp.where(valid, (2.0 * ph) ** 2, jnp.float32(-1.0))
        return (px, py, pz, r2), pidx, ovf

    def count(tgt, cand, level, exclude_self):
        return stencil(
            tgt, cand[:3], box.lengths, periodic, level, op="count",
            exclude_self=exclude_self,
        )

    # same-tier: the tier against itself at its own level; the target-side
    # ELL accumulator also receives the cross passes' coarse-tier legs
    overflow = jnp.bool_(False)
    packs = []  # per tier: (planes, pidx) at the tier's own level
    totals_ell = []
    for t in range(T):
        planes, pidx, ovf = pack(t, levels[t], caps[t])
        overflow = overflow | ovf
        packs.append((planes, pidx))
        totals_ell.append(count(planes, planes, levels[t], True))

    # cross passes at the coarser level a: tier-b gets its own pack there
    cross_results = []  # (pidx_b, vals_b) back-maps for the fine tier
    for a in range(T):
        for b in range(a + 1, T):
            planes_b, pidx_b, ovf_b = pack(b, levels[a], cross_caps[(a, b)])
            overflow = overflow | ovf_b
            planes_a = packs[a][0]
            totals_ell[a] = totals_ell[a] + count(
                planes_a, planes_b, levels[a], False)
            cross_results.append(
                (pidx_b, count(planes_b, planes_a, levels[a], False)))

    # back-map 1: the same-tier pidx sets PARTITION [0, n): one sort of
    # the concatenated (pidx, vals) puts every particle's own-layout total
    # at its tier-sorted position
    all_pidx = jnp.concatenate([packs[t][1].reshape(-1) for t in range(T)])
    all_vals = jnp.concatenate([v.reshape(-1) for v in totals_ell])
    ps, vs = jax.lax.sort((all_pidx, all_vals), num_keys=1, is_stable=False)
    total_ts = vs[:n]

    # back-map 2: each cross candidate leg covers exactly tier-b's
    # positions; pad with the OTHER tiers' pidx (zero values) to complete
    # the partition, sort, add
    for (pidx_b, vals_b), (a, b) in zip(
        cross_results,
        [(a, b) for a in range(T) for b in range(a + 1, T)],
    ):
        fill_p = jnp.concatenate(
            [packs[t][1].reshape(-1) for t in range(T) if t != b]
        )
        cp = jnp.concatenate([pidx_b.reshape(-1), fill_p])
        cv = jnp.concatenate(
            [vals_b.reshape(-1), jnp.zeros(fill_p.shape, vals_b.dtype)]
        )
        ps2, vs2 = jax.lax.sort((cp, cv), num_keys=1, is_stable=False)
        total_ts = total_ts + vs2[:n]

    # back to the caller's (key-sorted) order: orig_s is a permutation
    counts = jnp.zeros((n,), total_ts.dtype).at[orig_s].set(
        total_ts, unique_indices=True)
    return counts.astype(jnp.uint32), overflow
