"""Halo discovery, layout, and exchange as a reusable state machine.

JAX equivalent of the reference's Halos class (reference:
include/cstone/halos/halos.hpp:107-268): `discover` flags halo leaves via
the collision traversal, `compute_layout` derives the halos-owned-halos
buffer layout and records the request-keys exchange pattern as a
`HaloRecord` (reference exchange_keys.hpp:63-119 -> SendList), and
`exchange` replays that record per field (reference halos.hpp:232-251 —
the epoch-tagged MPI P2P becomes deterministic all_to_all collectives, so
no tags or epochs exist).

This is the SAME machinery `Domain._sync_p2p` drives inline during sync
(domain/domain.py steps 7-10); the class packages it for clients that
manage their own trees, mirroring the reference API surface.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..domain.layout import compute_node_layout
from ..ops.primitives import searchsorted as _searchsorted
from ..ops.primitives import segment_ids_from_offsets
from ..parallel.exchange import (
    HaloRecord,
    build_halo_exchange,
    exchange_halo_field,
)
from ..sfc.box import Box
from ..traversal.collisions import find_halos
from ..tree.octree import LinkedOctree

__all__ = ["Halos"]


class Halos:
    """discover -> compute_layout -> exchange (halos.hpp:107-268).

    Stateless per call except for the `HaloRecord` returned by
    compute_layout; pass that record to `exchange` for every field moved
    this epoch (the reference likewise reuses its SendList until the next
    discover/computeLayout, halos.hpp:232-267).
    """

    def __init__(
        self,
        n_ranks: int,
        axis_name: Optional[str] = None,
        search_ext_factor: float = 1.0,
    ):
        self.n_ranks = int(n_ranks)
        self.axis_name = axis_name
        self.search_ext_factor = float(search_ext_factor)

    # -- step 1: per-leaf halo flags (halos.hpp:116-189) -------------------
    def discover(
        self,
        tree: LinkedOctree,
        h_owned: jax.Array,
        n_owned,
        owned_keys: jax.Array,
        first_leaf,
        last_leaf,
        box: Box,
        curve: str = "hilbert",
    ) -> jax.Array:
        """Per-leaf halo flags from per-leaf max interaction radii.

        h_owned / owned_keys: smoothing lengths and SFC keys of locally
        owned particles in SFC order (keys locate particles per leaf, the
        segmentMax analog of halos.hpp:160-189).
        """
        cap_leaf = tree.leaves.shape[0] - 1
        cap = h_owned.shape[0]
        n_owned = jnp.asarray(n_owned, jnp.int32)
        leaf_off = _searchsorted(owned_keys, tree.leaves, side="left")
        leaf_off = jnp.minimum(leaf_off, n_owned)
        pseg = segment_ids_from_offsets(leaf_off, cap, cap_leaf)
        hv = jnp.where(jnp.arange(cap, dtype=jnp.int32) < n_owned, h_owned, 0.0)
        leaf_hmax = jax.ops.segment_max(
            hv, pseg, num_segments=cap_leaf, indices_are_sorted=True
        )
        leaf_hmax = jnp.maximum(leaf_hmax, 0.0)
        li = jnp.arange(cap_leaf, dtype=jnp.int32)
        mine = (li >= first_leaf) & (li < last_leaf)
        radii = jnp.where(
            mine,
            leaf_hmax * h_owned.dtype.type(2.0 * self.search_ext_factor),
            0.0,
        )
        return find_halos(tree, radii, box, first_leaf, last_leaf, curve)

    # -- step 2: layout + exchange pattern (halos.hpp:191-222) -------------
    def compute_layout(
        self,
        tree: LinkedOctree,
        leaf_counts: jax.Array,
        halo_flags: jax.Array,
        first_leaf,
        last_leaf,
        rank_boundaries: jax.Array,
        my_rank,
        owned_keys: jax.Array,
        n_owned,
        req_cap: int,
        halo_cap: int,
    ) -> Tuple[jax.Array, jax.Array, jax.Array, HaloRecord]:
        """Buffer layout (layout.hpp:150-164) + request-keys protocol
        (exchange_keys.hpp:63-119). Returns (layout, start, end, record);
        record.overflow mirrors the reference's checkHalos escalation
        (halos.hpp:205-222) — nonzero means caps must grow and the epoch
        is invalid.
        """
        cap_leaf = tree.leaves.shape[0] - 1
        li = jnp.arange(cap_leaf, dtype=jnp.int32)
        layout = compute_node_layout(leaf_counts, halo_flags, first_leaf, last_leaf)
        dest = (
            jnp.searchsorted(rank_boundaries, tree.leaves[:-1], side="right")
            .astype(jnp.int32)
            - 1
        )
        dest = jnp.clip(dest, 0, self.n_ranks - 1)
        mine = (li >= first_leaf) & (li < last_leaf)
        req = halo_flags.astype(bool) & (~mine) & (li < tree.n_leaf)
        rec = build_halo_exchange(
            tree.leaves[:-1], tree.leaves[1:], leaf_counts, layout, req,
            dest, owned_keys, n_owned, self.n_ranks, req_cap, halo_cap,
            self.axis_name,
        )
        return layout, layout[first_leaf], layout[last_leaf], rec

    # -- step 3: move one field (halos.hpp:232-251) -------------------------
    def exchange(
        self,
        owned_sorted: jax.Array,
        local_buf: jax.Array,
        record: HaloRecord,
    ) -> jax.Array:
        """Fill halo slots of `local_buf` from owner ranks."""
        return exchange_halo_field(owned_sorted, local_buf, record, self.axis_name)
