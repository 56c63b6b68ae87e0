"""Minimal SPH density pipeline on top of the Domain.

Mirrors the reference's intended client usage (reference: README.md:60-100):
every step, call domain.sync, find neighbors, compute a density-like
quantity from the neighborhood, exchange halos for it, and integrate.
This is the flagship end-to-end "model" the benchmarks drive.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from ..domain.domain import Domain, DomainState, SyncResult
from ..ops.primitives import cubic_spline_w as _cubic_spline_w

__all__ = ["SphState", "sph_density_step"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SphState:
    domain: DomainState
    x: jax.Array
    y: jax.Array
    z: jax.Array
    h: jax.Array
    m: jax.Array
    n_local: jax.Array


def sph_density_step(
    domain: Domain,
    state: SphState,
    ng_max: int = 192,
    group_size: int = 64,
    cand_leaf_cap: int = 128,
    cand_cap: int = 2048,
    chunk: int = 32,
    cell_level: int = 0,
    cell_cap: int = 0,
) -> Tuple[SphState, jax.Array, SyncResult]:
    """One density evaluation: sync + neighbor density sum.

    Returns (new_state, rho (local_capacity,), sync_result); rho is valid
    in [start_index, end_index).

    With `cell_level`/`cell_cap` set (host-side choices: choose_cell_level
    from max(h), cap from expected occupancy) the density runs the FUSED
    cell-list stencil — per-particle masses ride a candidate mass plane,
    no neighbor-index lists in device memory (find_neighbors.cuh:94-124's
    op-in-traversal design; traversal/celllist.cell_list_sph_density).
    Cell occupancy overflow folds into res.overflow for the usual host
    retry.
    Without them, the tree-traversal index path runs (the validation
    oracle and the fallback for strongly varying h).
    """
    dstate, res = domain.sync(
        state.domain, state.x, state.y, state.z, state.h,
        properties=(state.m,), n_local=state.n_local,
    )
    box = dstate.box
    (m_new,) = res.properties
    import dataclasses

    if cell_level and cell_cap:
        from ..traversal.celllist import cell_list_sph_density

        rho, cell_ovf = cell_list_sph_density(
            res.keys, res.x, res.y, res.z, res.h, box, int(cell_level),
            int(cell_cap), mass=m_new, n_valid=res.n_with_halos,
        )
        res = dataclasses.replace(
            res, overflow=jnp.maximum(res.overflow, cell_ovf.astype(jnp.int32))
        )
        co = domain.compact_owned
        new_state = SphState(
            domain=dstate, x=co(res, res.x), y=co(res, res.y),
            z=co(res, res.z), h=co(res, res.h), m=co(res, m_new),
            n_local=res.end_index - res.start_index,
        )
        return new_state, rho, res

    # density via a dedicated neighbor pass: sum_j m_j W(|rij|/h_i)
    from ..traversal.neighbors import _find_neighbors_impl

    view = domain.ns_view(res, box)
    cap = res.x.shape[0]
    counts, nbs, stats = _find_neighbors_impl(
        res.x, res.y, res.z, res.h, view, box,
        ng_max=ng_max, group_size=group_size, cand_leaf_cap=cand_leaf_cap,
        cand_cap=cand_cap, chunk=chunk, with_indices=True, n_targets=cap,
    )
    # fold neighbor-stage capacity overflows into the result flag so a
    # too-small cand_cap/ng_max can never silently drop neighbors
    # (reallocate.hpp:38-107 semantics: the caller grows and retries)
    in_buf = jnp.arange(cap, dtype=jnp.int32) < res.n_with_halos
    ns_overflow = (
        (stats.cand_max > cand_cap)
        | (stats.leaf_max > cand_leaf_cap)
        | (jnp.max(jnp.where(in_buf, counts, 0)) > ng_max)
    )
    import dataclasses

    res = dataclasses.replace(
        res, overflow=jnp.maximum(res.overflow, ns_overflow.astype(jnp.int32))
    )
    nb_valid = nbs >= 0
    nb = jnp.maximum(nbs, 0)
    dx = res.x[:, None] - res.x[nb]
    dy = res.y[:, None] - res.y[nb]
    dz = res.z[:, None] - res.z[nb]
    if any(b == 1 for b in box.boundaries):
        fdt = res.x.dtype
        L = box.lengths.astype(fdt)
        iL = (1.0 / box.lengths).astype(fdt)
        pm = jnp.asarray(box.periodic_mask, fdt)
        dx = dx - pm[0] * L[0] * jnp.round(dx * iL[0])
        dy = dy - pm[1] * L[1] * jnp.round(dy * iL[1])
        dz = dz - pm[2] * L[2] * jnp.round(dz * iL[2])
    r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    q = r / res.h[:, None]
    w = jnp.where(nb_valid, _cubic_spline_w(q) * m_new[nb], 0.0)
    norm = res.x.dtype.type(1.0 / jnp.pi) / (res.h * res.h * res.h)
    rho = norm * (
        jnp.sum(w, axis=-1) + m_new * _cubic_spline_w(jnp.zeros_like(res.h))
    )

    # carry only the OWNED particles into the next step (halos are
    # rediscovered each sync; keeping them as locals would double count)
    co = domain.compact_owned
    new_state = SphState(
        domain=dstate, x=co(res, res.x), y=co(res, res.y), z=co(res, res.z),
        h=co(res, res.h), m=co(res, m_new),
        n_local=res.end_index - res.start_index,
    )
    return new_state, rho, res
