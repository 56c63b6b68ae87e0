"""Dense cell-list neighbor search: ELL-packed grid bins + 27-point stencil.

Fast path for fixed-radius neighbor search, replacing per-group tree/grid
traversal with fully regular dataflow (reference semantics:
findneighbors.hpp:96-165 and traversal/find_neighbors.cuh:200-343 — same
neighbor definition, different algorithm). Exploits three structural
facts:

  1. at grid level ``level`` with cell side >= 2*h_max, every neighbor of
     a particle lies in the particle's own or the 26 adjacent cells;
  2. SFC-sorted particles are contiguous per grid cell, so binning is a
     row-gather, not a scatter;
  3. packing the bins in ROW-MAJOR grid order makes "adjacent cell" a
     constant index shift, so the 27-cell stencil is regular work with no
     neighbour lists.

The stencil itself has two implementations with one contract: the Pallas
kernel (ops/pallas_stencil.py) and the plain XLA roll stencil
(stencil_xla), which is also the kernel's reference; choose_stencil picks
one by platform. Periodic boundaries add +-L to the wrapped candidate
coordinates; open boundaries mask the wrapped cells. Self-pairs are
excluded by slot identity in the centre cell, matching the reference's
i != j rule — coincident points still count each other.

The ELL capacity ``cap`` bounds per-cell occupancy; cells with more
particles raise the overflow flag and the caller retries with a larger
cap (reference analog: util/reallocate.hpp growth loops).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pallas_stencil import INVALID_COORD
from ..ops.primitives import cubic_spline_w
from ..sfc.box import Box
from ..sfc.encode import HILBERT
from ..sfc.keys import max_tree_level

__all__ = [
    "choose_cell_level",
    "default_cell_cap",
    "rowmajor_cell_perm",
    "ell_pack_gather",
    "stencil_xla",
    "choose_stencil",
    "cell_list_neighbor_counts",
    "cell_list_sph_density",
]


def choose_cell_level(box: Box, h_max: float, ext: float = 1.0, max_level: int = 7) -> int:
    """Coarsest grid level whose cell side >= 2*h_max*ext on every dim.

    Returns at least 2 (a 4^3 grid) — the stencil needs >= 3 distinct
    cells per periodic dim to be correct, and level 2 keeps the wrap
    images unique. Callers should fall back to a dense path when the
    search radius is too large for level 2 (i.e. when 2*h_max*ext >
    min_side/4).
    """
    min_side = float(np.min(np.asarray(box.lengths)))
    r = 2.0 * float(h_max) * float(ext)
    if r <= 0.0:
        return max_level
    level = int(np.floor(np.log2(min_side / r))) if r < min_side else 0
    return max(2, min(max_level, level))


def default_cell_cap(n: int, level: int, snapshots: int = 1) -> int:
    """ELL capacity covering the Poisson occupancy tail of n uniform
    particles on the level-`level` grid. Extreme-value sizing: E[max over
    C cells and `snapshots` density snapshots] ~ mean + sqrt(2 ln(C *
    snapshots) * mean); add ~1 sigma + 6 margin. Rounded up to a multiple
    of 64 (64 at 1M particles on level 5). Overflow is flagged and the
    caller grows the cap, so a tight default is safe."""
    n_cells = float(1 << (3 * level)) * max(1, snapshots)
    mean = n / float(1 << (3 * level))
    cap = mean + math.sqrt(2.0 * math.log(n_cells) * mean) + 6.0
    return max(64, int(-(-cap // 64) * 64))


def _np_hilbert_cell(ix, iy, iz, level: int) -> np.ndarray:
    """Pure-NumPy Hilbert cell index at `level` from level-resolution grid
    coords — same per-round math as sfc/hilbert.py::ihilbert (reference:
    hilbert.hpp:58-109). NumPy (not jnp) so it stays concrete inside jit
    traces; only ever run for 8^level <= 2^21 cells, once per level."""
    px = ix.astype(np.uint32)
    py = iy.astype(np.uint32)
    pz = iz.astype(np.uint32)
    key = np.zeros(px.shape, np.uint32)
    for i in range(level):
        lv = np.uint32(level - 1 - i)
        xi = (px >> lv) & 1
        yi = (py >> lv) & 1
        zi = (pz >> lv) & 1
        octant = (xi << 2) | (yi << 1) | zi
        key = (key << np.uint32(3)) + ((octant ^ (octant >> 1)) ^ (octant >> 2))
        not_yi = yi ^ 1
        not_zi = zi ^ 1
        mx = xi & (not_yi | zi)
        my = (xi & (yi | zi)) | (yi & not_zi)
        mz = (xi & not_yi & not_zi) | (yi & not_zi)
        px = px ^ (np.uint32(0) - mx)
        py = py ^ (np.uint32(0) - my)
        pz = pz ^ (np.uint32(0) - mz)
        rot = zi == 1
        swp = (zi == 0) & (yi == 0)
        npx = np.where(rot, py, np.where(swp, pz, px))
        npy = np.where(rot, pz, py)
        npz = np.where(rot, px, np.where(swp, px, pz))
        px, py, pz = npx, npy, npz
    return key


def _np_morton_cell(ix, iy, iz, level: int) -> np.ndarray:
    out = np.zeros(ix.shape, np.uint32)
    for b in range(level):
        out |= ((ix >> b) & 1).astype(np.uint32) << np.uint32(3 * b + 2)
        out |= ((iy >> b) & 1).astype(np.uint32) << np.uint32(3 * b + 1)
        out |= ((iz >> b) & 1).astype(np.uint32) << np.uint32(3 * b)
    return out


@lru_cache(maxsize=32)
def _rowmajor_cell_perm_np(level: int, curve: str) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, inv_perm): perm[r] = SFC cell index of row-major cell r.

    Static per (level, curve) — computed once in NumPy and cached; the
    stencil path then never encodes keys for cells at runtime.
    """
    d = 1 << level
    ij = np.arange(d, dtype=np.uint32)
    ix, iy, iz = np.meshgrid(ij, ij, ij, indexing="ij")
    enc = _np_hilbert_cell if curve == HILBERT else _np_morton_cell
    perm = enc(ix.ravel(), iy.ravel(), iz.ravel(), level).astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return perm, inv


def rowmajor_cell_perm(level: int, curve: str = HILBERT) -> Tuple[jax.Array, jax.Array]:
    perm, inv = _rowmajor_cell_perm_np(int(level), curve)
    return jnp.asarray(perm), jnp.asarray(inv)


def ell_pack_gather(
    keys_sorted: jax.Array,  # (n,) SFC-sorted particle keys
    perm: jax.Array,  # (n_cells,) row-major -> SFC cell index
    arrays: Tuple[jax.Array, ...],  # (n,) sorted f32 particle fields
    cap: int,
    level: int,
    n_valid=None,
    blk: int = 64,
    cell_override: jax.Array = None,
) -> Tuple[Tuple[jax.Array, ...], jax.Array, jax.Array, jax.Array]:
    """Run-window ELL pack: one stacked row gather over per-cell runs.

    SFC-sorted particles are CONTIGUOUS per grid cell, so the pack is a
    window copy per cell, not a scatter: cell starts come from one
    searchsorted over the top key bits, and ALL fields ride a single
    (n_cells*cap)-row gather of the stacked (n, F) array. The
    slot->particle backmap (pidx) is arithmetic (start + lane), no
    scatter at all.

    The windows ride a blk-PARTICLE-BLOCK gather + shift-select rather
    than a per-slot gather: fetching (cap/blk + 1) rows of blk stacked
    particles per cell costs n_cells*(cap/blk + 1) gather indices instead
    of n_cells*cap, then each cell's window is realigned to its run start
    with log2(blk) static-slice selects (off = start % blk), which XLA
    fuses into one elementwise pass.

    Returns (packed (n_cells, cap) arrays in row-major cell order, valid,
    pidx, overflow): pidx maps ELL slots back to sorted particle positions
    (INT32_MAX in empty slots, so they sort last); empty slots of every
    packed field hold INVALID_COORD.
    """
    n = keys_sorted.shape[0]
    dt = keys_sorted.dtype
    L = max_tree_level(dt)
    shift = dt.type(3 * (L - level))
    n_cells = 1 << (3 * level)
    F = len(arrays)
    assert all(a.dtype == jnp.float32 for a in arrays)

    if cell_override is not None:
        # caller-provided sorted cell ids (tiered path: -1 / n_cells
        # sentinels route foreign-tier particles out of every run)
        cell = cell_override.astype(jnp.int32)
    else:
        # clamp in the key dtype BEFORE the int32 cast (sentinel keys at
        # shift 0 would wrap negative); force slots past n_valid to the
        # out-of-range cell so they fall out of every run
        cell = jnp.minimum(
            keys_sorted >> shift, dt.type(n_cells)).astype(jnp.int32)
    if n_valid is not None:
        i = jnp.arange(n, dtype=jnp.int32)
        cell = jnp.where(i < jnp.asarray(n_valid, jnp.int32), cell, n_cells)

    bounds = _searchsorted_i32(cell, n_cells)
    starts = bounds[:-1]
    counts = bounds[1:] - starts
    overflow = jnp.max(counts) > cap

    s_rm = starts[perm]
    c_rm = counts[perm]

    # stacked blk-particle rows, padded so every cell's (cap/blk + 1)-row
    # window stays in bounds with INVALID fill; larger blk trades gather
    # indices for a wider realign select
    while cap % blk:
        blk //= 2
    blk = max(blk, 1)
    pad = cap + blk + (-(n + cap + blk)) % blk
    stackedB = jnp.stack(
        [jnp.concatenate([a, jnp.full((pad,), INVALID_COORD, jnp.float32)])
         for a in arrays],
        axis=-1,
    ).reshape(-1, blk * F)
    nrowB = stackedB.shape[0]

    nr = cap // blk + 1  # covers cap slots at any run offset 0..blk-1
    r = jnp.arange(nr, dtype=jnp.int32)
    rows = jnp.minimum((s_rm // blk)[:, None] + r[None, :], nrowB - 1)
    win = stackedB[rows].reshape(n_cells, nr * blk * F)
    off = s_rm % blk
    # binary-select realign: log2(blk) conditional shifts instead of a
    # blk-way one-hot select
    rem = blk - 1
    b = blk >> 1
    while b:
        w_next = cap * F + (rem - b) * F
        keep = jax.lax.slice_in_dim(win, 0, w_next, axis=1)
        shift = jax.lax.slice_in_dim(win, b * F, b * F + w_next, axis=1)
        win = jnp.where(((off & b) != 0)[:, None], shift, keep)
        rem -= b
        b >>= 1
    blk4 = win.reshape(n_cells, cap, F)

    j = jnp.arange(cap, dtype=jnp.int32)
    valid = j[None, :] < c_rm[:, None]
    blk4 = jnp.where(valid[:, :, None], blk4, INVALID_COORD)
    packed = tuple(blk4[..., f] for f in range(F))
    pidx = jnp.where(valid, s_rm[:, None] + j[None, :], np.iinfo(np.int32).max)
    return packed, valid, pidx, overflow


def _searchsorted_i32(cell_sorted: jax.Array, n_cells: int) -> jax.Array:
    """searchsorted(cell_sorted, arange(n_cells+1)) via the sort method
    of ops/primitives.searchsorted."""
    from ..ops.primitives import searchsorted

    q = jnp.arange(n_cells + 1, dtype=jnp.int32)
    return searchsorted(cell_sorted, q, side="left").astype(jnp.int32)




def _roll3(a: jax.Array, dx: int, dy: int, dz: int) -> jax.Array:
    """a is (D, D, D, ...); rolled so cell (i,j,k) sees (i+dx, j+dy, k+dz)."""
    if dx:
        a = jnp.roll(a, -dx, axis=0)
    if dy:
        a = jnp.roll(a, -dy, axis=1)
    if dz:
        a = jnp.roll(a, -dz, axis=2)
    return a


def stencil_xla(
    tgt: Sequence[jax.Array],  # (tx, ty, tz, r2|h), each (n_cells, cap_t)
    cand: Sequence[jax.Array],  # (cx, cy, cz), each (n_cells, cap_c)
    lengths,  # (3,) box lengths; may be traced
    periodic: Tuple[bool, bool, bool],
    level: int,
    op: str = "count",
    exclude_self: bool = True,
    cand_mass: Optional[jax.Array] = None,  # (n_cells, cap_c), 0 in empties
) -> jax.Array:
    """(n_cells, cap_t) target-side 27-point stencil sums in plain XLA.

    The plain reference of ops/pallas_stencil.stencil_pallas, with the
    same contract: op="count" counts candidates with d2 < r2_i (int32),
    op="density" sums m_j W(|r_ij| / h_i) (float32, m_j = 1 without a
    mass plane). Targets and candidates are ELL grids on the same
    row-major level-`level` cell grid; empty candidate slots sit at
    INVALID_COORD, empty targets carry r2 < 0 (count) or h = 1e30
    (density). exclude_self drops the j == i slot pair of the centre cell
    (targets and candidates are one pack). Neighbour cells are jnp.roll
    shifts of the candidate grid: the roll is the periodic wrap, +-L
    corrects the coordinate, and open boundaries mask the wrapped cells.
    """
    if op not in ("count", "density"):
        raise ValueError(f"unknown stencil op {op!r}")
    D = 1 << int(level)
    cap_t = tgt[0].shape[1]
    cap_c = cand[0].shape[1]
    tx, ty, tz, tp = (
        a.astype(jnp.float32).reshape(D, D, D, cap_t, 1) for a in tgt)
    grid_c = [a.astype(jnp.float32).reshape(D, D, D, cap_c) for a in cand]
    mass = (None if cand_mass is None
            else cand_mass.astype(jnp.float32).reshape(D, D, D, cap_c))
    L = jnp.asarray(lengths, jnp.float32).reshape(3)
    idx = jnp.arange(D, dtype=jnp.int32)
    if op == "density":
        inv_h = 1.0 / tp
    same_slot = (jnp.arange(cap_t)[:, None] == jnp.arange(cap_c)[None, :])

    acc = jnp.zeros((D, D, D, cap_t), jnp.float32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                c = [_roll3(a, dx, dy, dz) for a in grid_c]
                keep = None  # (D, D, D, 1, 1) open-boundary mask
                for axis, d in enumerate((dx, dy, dz)):
                    if d == 0:
                        continue
                    shape = [1, 1, 1, 1]
                    shape[axis] = D
                    wrap = ((idx + d) // D).reshape(shape)  # -1, 0, +1
                    if periodic[axis]:
                        c[axis] = c[axis] + wrap.astype(jnp.float32) * L[axis]
                    else:
                        k = (wrap == 0)[..., None]
                        keep = k if keep is None else keep & k
                ddx = tx - c[0][..., None, :]
                ddy = ty - c[1][..., None, :]
                ddz = tz - c[2][..., None, :]
                d2 = ddx * ddx + ddy * ddy + ddz * ddz
                if op == "count":
                    term = (d2 < tp).astype(jnp.float32)
                else:
                    term = cubic_spline_w(jnp.sqrt(d2) * inv_h)
                    if mass is not None:
                        term = term * _roll3(mass, dx, dy, dz)[..., None, :]
                if keep is not None:
                    term = jnp.where(keep, term, 0.0)
                if exclude_self and (dx, dy, dz) == (0, 0, 0):
                    term = jnp.where(same_slot, 0.0, term)
                acc = acc + jnp.sum(term, axis=-1)

    acc = acc.reshape(-1, cap_t)
    return acc.astype(jnp.int32) if op == "count" else acc


def choose_stencil(platform: Optional[str] = None):
    """The stencil implementation for `platform` (default: JAX's default
    backend): the compiled Pallas kernel on "gpu", the plain XLA stencil
    everywhere else."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        from ..ops.pallas_stencil import stencil_pallas

        return stencil_pallas
    return stencil_xla


# When set, the stencil the entry points run instead of choose_stencil()'s
# pick: the seam through which tests run the kernel in interpret mode and
# chip_smoke.py times the kernel against the plain stencil. Read at trace
# time.
_stencil_override = None


def _stencil():
    return _stencil_override or choose_stencil()


def stencil_stats(
    offsets: jax.Array,  # (n_cells+1,) from build_cell_table (SFC order)
    perm: jax.Array,  # (n_cells,) row-major -> SFC cell index
    level: int,
) -> Tuple[jax.Array, jax.Array]:
    """(pairs_tested, max_occupancy) — NcStats analog for the stencil
    (reference find_neighbors.cuh:346-369 sumP2P/maxP2P). pairs_tested is
    the exact number of distance evaluations the 27-point stencil
    performs: sum over cells of occ(c) * occ(27-neighborhood of c)."""
    D = 1 << int(level)
    occ_i = offsets[perm + 1] - offsets[perm]
    # f32 accumulation: a diagnostic counter (pairs can exceed int32 at
    # large N)
    occ = occ_i.astype(jnp.float32).reshape(D, D, D)
    nb = jnp.zeros_like(occ)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nb = nb + _roll3(occ, dx, dy, dz)
    pairs = jnp.sum(occ * nb)
    return pairs, jnp.max(occ_i).astype(jnp.int32)


def _backmap_sort(pidx: jax.Array, vals_ell: jax.Array, n: int) -> jax.Array:
    """ELL slot values back to sorted particle order: one sort by the
    slot's particle index (empty slots carry INT32_MAX and sort last)."""
    _, vals = jax.lax.sort(
        (pidx.reshape(-1), vals_ell.reshape(-1)), num_keys=1, is_stable=False
    )
    return vals[:n]


def cell_list_neighbor_counts(
    keys_sorted: jax.Array,  # (n,) SFC-sorted particle keys
    xs: jax.Array,  # (n,) coords in the same (sorted) order
    ys: jax.Array,
    zs: jax.Array,
    hs: jax.Array,  # (n,) interaction radii; neighbor iff d2 < (2h_i)^2
    box: Box,
    level: int,
    cap: int,
    curve: str = HILBERT,
    n_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """(n,) neighbor counts in sorted particle order + overflow flag.

    Exact fixed-radius neighbor counts (reference findneighbors.hpp:96-165
    semantics) provided the grid cell side at `level` is >= 2*max(hs):
    use choose_cell_level. Overflow=True means some cell held more than
    `cap` particles and the result is invalid — retry with a larger cap.
    The stencil is choose_stencil()'s. No cell table is needed: the pack
    derives cells from the key bits.
    """
    n = keys_sorted.shape[0]
    perm, _ = rowmajor_cell_perm(int(level), curve)
    (px, py, pz, ph), valid, pidx, overflow = ell_pack_gather(
        keys_sorted, perm, (xs, ys, zs, hs), cap, int(level), n_valid=n_valid
    )
    r2 = jnp.where(valid, (2.0 * ph) ** 2, jnp.float32(-1.0))
    periodic = tuple(int(b) == 1 for b in box.boundaries)
    counts_ell = _stencil()(
        (px, py, pz, r2), (px, py, pz), box.lengths, periodic, int(level),
        op="count", exclude_self=True,
    )

    # back to particle order via ONE sort instead of a per-particle
    # gather: the pack recorded each slot's particle index
    count_bits = int(27 * cap).bit_length()  # counts <= 27*cap structurally
    if (n + 1) << count_bits < (1 << 31):
        # fused-key backmap: (pidx << bits | count) rides ONE u32 sort
        # (half the sort payload). Empty slots carry pidx = INT32_MAX,
        # whose shifted u32 wrap (2^32 - 2^bits) still sorts after every
        # valid key (< 2^31).
        key = (
            (pidx.reshape(-1).astype(jnp.uint32) << count_bits)
            | counts_ell.reshape(-1).astype(jnp.uint32)
        )
        key_s = jax.lax.sort(key)
        counts = key_s[:n] & jnp.uint32((1 << count_bits) - 1)
    else:
        counts = _backmap_sort(pidx, counts_ell, n).astype(jnp.uint32)
    return counts, overflow


def cell_list_sph_density(
    keys_sorted: jax.Array,  # (n,) SFC-sorted particle keys
    xs: jax.Array,  # (n,) coords in the same (sorted) order
    ys: jax.Array,
    zs: jax.Array,
    hs: jax.Array,  # (n,) smoothing lengths; kernel support radius = 2h
    box: Box,
    level: int,
    cap: int,
    mass=1.0,  # uniform scalar mass OR (n,) per-particle masses
    curve: str = HILBERT,
    n_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """(n,) SPH densities in sorted particle order + overflow flag.

    rho_i = (1 / pi h_i^3) * (sum_{j != i} m_j W(|r_ij| / h_i) + m_i W(0))
    with the cubic-spline W — identical formula to models/sph.py's
    tree-path density, but the interaction is fused into the stencil
    pass: no neighbor-index lists in device memory (the reference runs its
    per-pair op inside the warp traversal the same way,
    find_neighbors.cuh:94-124; the separate findNeighbors+force-loop shape
    is kept only on the tree path for API parity). `mass` may be a scalar
    (uniform m factored out of the sum) or an (n,) array in the same
    sorted order (packed as a candidate mass plane). Exact provided the
    grid cell side at `level` is >= 2*max(hs).
    """
    n = keys_sorted.shape[0]
    perm, _ = rowmajor_cell_perm(int(level), curve)

    per_particle_m = getattr(mass, "ndim", 0) == 1
    fields = (xs, ys, zs, hs) + (
        (jnp.asarray(mass, jnp.float32),) if per_particle_m else ())
    packed, valid, pidx, overflow = ell_pack_gather(
        keys_sorted, perm, fields, cap, int(level), n_valid=n_valid
    )
    px, py, pz, ph = packed[:4]
    pm = jnp.where(valid, packed[4], 0.0) if per_particle_m else None
    periodic = tuple(int(b) == 1 for b in box.boundaries)
    wsum = _stencil()(
        (px, py, pz, ph), (px, py, pz), box.lengths, periodic, int(level),
        op="density", exclude_self=True, cand_mass=pm,
    )
    # self term m_i * W(0) = m_i (unnormalized cubic spline) + normalization
    inv_h = jnp.where(valid, 1.0 / ph, 0.0)
    if per_particle_m:
        rho_ell = (np.float32(1.0 / np.pi)) * (
            (wsum + pm) * inv_h * inv_h * inv_h
        )
    else:
        rho_ell = (jnp.float32(mass) / np.float32(np.pi)) * (
            (wsum + 1.0) * inv_h * inv_h * inv_h
        )
    return _backmap_sort(pidx, rho_ell, n), overflow
