"""The Domain: global octree + decomposition + particle/halo management.

JAX re-design of the reference's top-level API (reference:
include/cstone/domain/domain.hpp). One `Domain.sync` call corresponds to
Domain::sync (domain.hpp:197-243): assign particles to ranks along the SFC,
exchange them, discover halos, and lay out local buffers as
[halos | assigned | halos], so that after sync every rank can run
neighbor searches over its assignment.

JAX adaptation (v1): a "rank" is a position on the device-mesh axis; all
collective steps are XLA collectives inside shard_map. The particle
exchange is implemented as all_gather + global sort + slice: because the
exchanged pool is globally SFC-sorted, every leaf cell's particles sit at
[gscan[i], gscan[i+1]) in the pool, and both assigned and halo particles
of every rank are pure gathers from it. This replaces the reference's
sparse point-to-point MPI exchange (domaindecomp_mpi.hpp,
exchange_halos.hpp) with two dense collectives — the natural first mapping
onto the device interconnect; a ppermute-based neighbor exchange is the planned optimization.

All shapes are static: local buffers have a fixed per-rank capacity and
invalid slots carry the removeKey sentinel, which sorts behind every valid
key and is excluded from every count.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.primitives import searchsorted as _searchsorted
from ..ops.primitives import segment_ids_from_offsets
from ..parallel.global_tree import global_bounds
from ..sfc.box import Box
from ..sfc.encode import HILBERT, compute_sfc_keys
from ..sfc.keys import max_tree_level, node_range, remove_key
from ..traversal.collisions import find_halos
from ..traversal.macs import inv_theta_min_mac
from ..traversal.neighbors import OctreeNsView, make_ns_view
from ..traversal.peers import find_peers_mac
from ..tree.csarray import CsArray, compute_node_counts, root_tree
from ..tree.octree import LinkedOctree, build_linked_octree
from .decomposition import (
    SfcAssignment,
    create_send_offsets,
    limit_boundary_shifts,
    make_sfc_assignment,
    translate_assignment,
)
from .layout import compute_node_layout

__all__ = ["Domain", "DomainState", "SyncResult"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DomainState:
    """Cross-step Domain state (replicated parts are identical on all ranks)."""

    box: Box
    assignment: SfcAssignment
    global_tree: CsArray
    focus_leaves: jax.Array  # (focus_capacity+1,) cornerstone keys
    focus_n: jax.Array
    first_call: jax.Array  # bool
    # carried linked octree: when the global tree's rebalance decision says
    # "converged" the leaf array is bit-identical to last step's, so the
    # linked structure is reused instead of rebuilt (the reference's
    # rebalanceStatus freshness guard + convergence short-circuit,
    # octree_focus_mpi.hpp:669-677, csarray.hpp:430-448)
    linked: LinkedOctree
    # True when last sync's focus converge reported convergence: the next
    # sync's first converge iteration then reuses `linked` instead of
    # rebuilding it from focus_leaves (multi-rank warm path — the same
    # freshness guard applied past n_ranks == 1)
    focus_converged: jax.Array


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SyncResult:
    """Per-rank outputs of one sync step.

    Local particle buffers are in layout order: halo cells and assigned
    cells interleaved along the SFC; [start_index, end_index) brackets the
    locally-owned (assigned) particles (domain.hpp:144-194).
    """

    keys: jax.Array
    x: jax.Array
    y: jax.Array
    z: jax.Array
    h: jax.Array
    properties: Tuple[jax.Array, ...]
    start_index: jax.Array
    end_index: jax.Array
    n_with_halos: jax.Array
    global_ids: jax.Array  # pool mode: pool index per local slot (None in p2p)
    sort_order: jax.Array  # pre-sync local slot per sorted position
    pool_perm: jax.Array  # pool mode: ExchangeLog analog (None in p2p)
    layout: jax.Array  # (cap_leaf+1,) local particle offsets per global leaf
    halo_flags: jax.Array
    tree: LinkedOctree
    leaf_counts: jax.Array
    overflow: jax.Array  # >0 if any capacity was exceeded
    ex_record: object = None  # p2p mode: parallel.exchange.ExchangeRecord
    halo_record: object = None  # p2p mode: parallel.exchange.HaloRecord
    # (7,) int32 per-capacity overflow indicators, pmax'd across ranks:
    # [local_buffer, tree_capacity, focus_capacity, move_cap,
    #  treelet_cap, halo_caps, peer_window] — each entry 0 or the required
    # size (where known), so a host retry loop can grow precisely
    # (util/reallocate.hpp:38-107 semantics)
    overflow_detail: jax.Array = None


CAP_NAMES = ("local", "tree", "focus", "move", "treelet", "halo", "window")


def sync_with_retry(run_sync, caps: dict, max_retries: int = 4, growth: float = 1.6):
    """Host-side capacity-growth loop (reallocate.hpp:38-107 semantics).

    run_sync(caps) builds a Domain with the given capacities (keys
    CAP_NAMES: local buffer size, tree_capacity, focus_capacity, move_cap,
    treelet_cap, halo caps), runs one sync (+ downstream work), and
    returns anything whose last element is a SyncResult. On overflow, the
    capacities named by result.overflow_detail are grown by `growth` (and
    at least to the reported required size) and run_sync is re-invoked —
    a re-jit with larger static shapes, exactly the role of the
    reference's reallocate-and-redo loops. Raises after max_retries.
    """
    import numpy as np_

    caps = dict(caps)
    for _ in range(max_retries + 1):
        out = run_sync(dict(caps))
        res = out[-1] if isinstance(out, tuple) else out
        if int(np_.asarray(res.overflow)) == 0:
            return out, caps
        if res.overflow_detail is not None:
            detail = np_.asarray(res.overflow_detail)
        else:
            detail = np_.ones((len(CAP_NAMES),), np_.int64)  # grow everything
        for i, nm in enumerate(CAP_NAMES):
            if i < len(detail) and detail[i] > 0:
                need = int(detail[i])
                grown = int(caps.get(nm, 0) * growth) + 8
                caps[nm] = max(grown, need + 8)
    hint = ""
    focus_i = CAP_NAMES.index("focus")
    if (
        res.overflow_detail is not None
        and detail[focus_i] > 0
        and int(detail[focus_i]) <= caps["focus"]
    ):
        # focus_converge reports required size when capacity is truly
        # short; a report at/below the current capacity means the converge
        # loop hit max_iters without settling (oscillating decisions), and
        # growing capacity cannot fix that
        hint = (
            " — focus overflow <= current capacity indicates focus"
            " NON-CONVERGENCE (oscillating rebalance), not a capacity"
            " shortfall; inspect bucket_size_focus / mandatory keys"
        )
    raise RuntimeError(
        f"sync still overflows after {max_retries} retries: caps={caps},"
        f" last overflow_detail={detail.tolist()}{hint}"
    )


class Domain:
    """Top-level domain decomposition driver (domain.hpp:67-113).

    Parameters mirror the reference ctor: bucket_size (global tree),
    bucket_size_focus (LET), theta (MAC opening). n_ranks == 1 gives the
    single-chip path with all collectives elided; n_ranks > 1 requires
    calling `sync` inside shard_map with `axis_name` bound.
    """

    def __init__(
        self,
        rank: int | jax.Array,
        n_ranks: int,
        bucket_size: int,
        bucket_size_focus: int = 0,
        theta: float = 0.5,
        key_dtype=jnp.uint64,
        curve: str = HILBERT,
        local_capacity: int = 0,
        tree_capacity: int = 0,
        focus_capacity: int = 0,
        axis_name: Optional[str] = None,
        halo_search_ext: float = 1.0,
        exchange_mode: str = "p2p",
        move_cap: int = 0,
        treelet_cap: int = 0,
        halo_req_cap: int = 0,
        halo_cap: int = 0,
        peer_window: int = 0,
        protocol: Optional[str] = None,
    ):
        self.rank = rank
        self.n_ranks = int(n_ranks)
        self.bucket_size = int(bucket_size)
        self.bucket_size_focus = int(bucket_size_focus) or int(bucket_size)
        self.theta = float(theta)
        self.key_dtype = np.dtype(key_dtype)
        self.curve = curve
        self.local_capacity = int(local_capacity)
        self.tree_capacity = int(tree_capacity)
        self.focus_capacity = int(focus_capacity) or int(tree_capacity)
        self.axis_name = axis_name
        self.halo_search_ext = float(halo_search_ext)
        # p2p exchange capacities (grown by host retry loops on overflow,
        # the reallocate analog, util/reallocate.hpp:38-107). Zero = derive
        # defaults from the other capacities at sync time.
        self.exchange_mode = exchange_mode
        self.move_cap = int(move_cap)
        self.treelet_cap = int(treelet_cap)
        self.halo_req_cap = int(halo_req_cap)
        self.halo_cap = int(halo_cap)
        # peer_window > 0 scopes the count-service and halo protocols to
        # ranks within +-peer_window on the rank axis (SFC-surface peers,
        # the findPeersMac bound, peers.hpp:63-117): buffers become
        # (2W+1, cap) instead of (n_ranks, cap) and the exchanges ride
        # ppermute rounds between neighbouring ranks. Cells owned by ranks outside
        # the window take their counts from the global tree (rangeCount,
        # focus/rebalance.hpp:279-299). A too-small window is reported in
        # overflow_detail[6] (the max rank offset actually needed) and
        # grown by sync_with_retry like any other capacity. 0 = dense
        # all_to_all over the full rank axis.
        self.peer_window = min(int(peer_window), max(self.n_ranks - 1, 0))
        # protocol="ragged" routes the count/sum services and the halo
        # request-keys protocol over jax.lax.ragged_all_to_all: one
        # concatenated dest-sorted operand per exchange, buffers sized by
        # the MEASURED surface total, independent of the rank count
        # (parallel/ragged.py — the peers.hpp:63-117 traffic bound realized
        # as one collective). treelet_cap / halo_req_cap / halo_cap then mean
        # TOTALS per rank instead of per-pair lane widths, still grown by
        # sync_with_retry on overflow. "dense" keeps the (R, cap)
        # all_to_all protocols; peer_window applies to dense only.
        # protocol=None auto-selects: ragged where the native
        # ragged_all_to_all is switched on (parallel/ragged.use_native_ragged,
        # CSTONE_RAGGED=native), dense elsewhere (ragged runs the emulation
        # only when asked for).
        if protocol is None:
            from ..parallel.ragged import use_native_ragged

            protocol = "ragged" if use_native_ragged() else "dense"
        if protocol not in ("dense", "ragged"):
            raise ValueError(f"unknown protocol {protocol!r}")
        if protocol == "ragged" and self.peer_window:
            # the ragged services are already surface-total-sized and do
            # their own per-rank routing; a rank window neither bounds nor
            # scopes them, and letting it through would make
            # sync_with_retry grow a knob with no effect (overflow_detail
            # keeps a window slot only for the dense/windowed path).
            raise ValueError(
                "peer_window applies to protocol='dense' only; the ragged "
                "protocols are surface-sized without a rank window"
            )
        self.protocol = protocol

    # ------------------------------------------------------------------
    def init_state(self, box: Optional[Box] = None, boundaries=(0, 0, 0)) -> DomainState:
        """Initial state. For periodic/fixed boundaries pass an explicit box
        — its limits are authoritative (box_mpi.hpp:85-119)."""
        dt = self.key_dtype
        if box is None:
            box = Box(
                limits=jnp.zeros((6,), jnp.float32), boundaries=tuple(boundaries)
            )
        nr = jnp.zeros((self.n_ranks + 1,), dtype=dt)
        assignment = SfcAssignment(
            boundaries=nr, counts=jnp.zeros((self.n_ranks,), jnp.int64)
        )
        tree = root_tree(dt, self.tree_capacity)
        focus0 = root_tree(dt, self.focus_capacity)
        return DomainState(
            box=box, assignment=assignment, global_tree=tree,
            focus_leaves=focus0.keys, focus_n=jnp.int32(1),
            first_call=jnp.bool_(True),
            linked=build_linked_octree(focus0.keys, jnp.int32(1)),
            focus_converged=jnp.bool_(False),
        )

    # ------------------------------------------------------------------
    def _pgather(self, x):
        """all_gather over the rank axis -> leading axis n_ranks."""
        if self.axis_name is None:
            return x[None]
        return jax.lax.all_gather(x, self.axis_name)

    def _psum(self, x):
        if self.axis_name is None:
            return x
        return jax.lax.psum(x, self.axis_name)

    # ------------------------------------------------------------------
    def sync(
        self,
        state: DomainState,
        x: jax.Array,
        y: jax.Array,
        z: jax.Array,
        h: jax.Array,
        properties: Sequence[jax.Array] = (),
        n_local=None,
        boundaries=None,
        grav: bool = False,
    ) -> Tuple[DomainState, SyncResult]:
        """One sync step (domain.hpp:197-243). Call inside shard_map when
        n_ranks > 1.

        x, y, z, h, properties: (local_capacity,) per-rank arrays; slots
        beyond n_local are ignored. Returns (new_state, SyncResult).

        With grav=True this is syncGrav (domain.hpp:246-325): properties[0]
        must be the mass; the focus tree uses the worst-case vector MAC and
        halo flags are augmented with mass-center vector-MAC failures
        (focusTree.addMacs, octree_focus_mpi.hpp:601-610). The reference's
        center-drift retry loop is unnecessary here because expansion
        centers are recomputed exactly every step.

        exchange_mode="p2p" (default) routes all particle/halo/count
        communication through peer-local all_to_all protocols with
        O(local+surface) cost per rank (parallel/exchange.py);
        exchange_mode="pool" keeps the round-1 all_gather + global-sort
        pool, which is O(N_global) per rank but useful for validation.
        """
        if grav and len(properties) == 0:
            raise ValueError("sync(grav=True) requires the mass as properties[0]")
        if self.exchange_mode == "p2p":
            return self._sync_p2p(
                state, x, y, z, h, properties, n_local, boundaries, grav
            )
        (box, keys, sort_order, xs, ys, zs, hs, props_s, tree, assignment,
         n_local, valid, _tree_changed) = self._common_assign(
            state, x, y, z, h, properties, n_local, boundaries
        )
        dt = self.key_dtype
        cap = x.shape[0]
        fdt = x.dtype
        rk = remove_key(dt)

        # ---- 5. particle exchange: all_gather + global merge ---------------
        pool = self._pgather(keys)  # (R, cap) keys
        payload = (xs, ys, zs, hs) + props_s
        pool_payload = tuple(self._pgather(p) for p in payload)
        pool_keys = pool.reshape(-1)
        pool_payload = tuple(p.reshape(-1) for p in pool_payload)
        pool_iota = jnp.arange(pool_keys.shape[0], dtype=jnp.int32)
        pool_sorted = jax.lax.sort(
            (pool_keys, pool_iota) + pool_payload, num_keys=1, is_stable=True
        )
        pool_keys = pool_sorted[0]
        pool_perm = pool_sorted[1]  # ExchangeLog analog (index_ranges.hpp:188)
        pool_payload = pool_sorted[2:]

        # ---- 6. focused octree (LET) ----------------------------------------
        # Built to bucket_size_focus inside this rank's assignment, coarse
        # outside per MAC, with mandatory resolution at all rank boundaries
        # (focus/octree_focus_mpi.hpp:108-187). Exact counts come from the
        # pool; see focus/octree_focus.py.
        from ..focus.octree_focus import focus_converge
        from ..traversal.macs import inv_theta_min_mac, inv_theta_vec_mac

        # syncGrav uses the worst-case vector MAC for the tree structure
        # (domain.hpp:266)
        _itm = inv_theta_vec_mac if grav else inv_theta_min_mac

        my_rank = jnp.asarray(self.rank, jnp.int32)
        focus_start = assignment.boundaries[my_rank]
        focus_end = assignment.boundaries[my_rank + 1]
        n_pool_valid = self._psum(n_local).astype(jnp.int32)

        focus_leaves0, focus_n0 = state.focus_leaves, state.focus_n
        (_, _, linked, node_counts_f, focus_conv_ovf, _,
         focus_converged) = focus_converge(
            focus_leaves0,
            focus_n0,
            pool_keys,
            n_pool_valid,
            box,
            focus_start,
            focus_end,
            assignment.boundaries,
            self.bucket_size_focus,
            _itm(self.theta),
            axis_name=self.axis_name,
            curve=self.curve,
            linked0=state.linked,
            use_carried=state.focus_converged & ~state.first_call,
        )
        cap_leaf = linked.leaves.shape[0] - 1
        # leaf counts extracted from the converge loop's final count pass
        # (upsweep keeps leaf values at leaf positions) — no second
        # pool_leaf_counts round
        lif = jnp.arange(cap_leaf, dtype=jnp.int32)
        leaf_counts = jnp.where(
            lif < linked.n_leaf, node_counts_f[linked.leaf_order()], jnp.uint32(0)
        )

        first_leaf = _searchsorted(linked.leaves, focus_start, side="left")[()]
        last_leaf = _searchsorted(linked.leaves, focus_end, side="left")[()]

        # per-leaf interaction radii: 2 * ext * max(h) over the leaf's
        # particles, nonzero only for assigned leaves (halos.hpp:116-189)
        pool_h = pool_payload[3]
        n_pool = pool_h.shape[0]
        leaf_pool_off = _searchsorted(pool_keys, linked.leaves, side="left")
        leaf_pool_off = jnp.minimum(leaf_pool_off, n_pool_valid)
        pseg = segment_ids_from_offsets(leaf_pool_off, n_pool, cap_leaf)
        leaf_hmax = jax.ops.segment_max(
            pool_h, pseg, num_segments=cap_leaf, indices_are_sorted=True
        )
        leaf_hmax = jnp.maximum(leaf_hmax, 0.0)  # empty segments -> -inf -> 0
        li = jnp.arange(cap_leaf, dtype=jnp.int32)
        mine = (li >= first_leaf) & (li < last_leaf)
        radii = jnp.where(
            mine, leaf_hmax * fdt.type(2.0 * self.halo_search_ext), 0.0
        )

        halo_flags = find_halos(
            linked, radii, box, first_leaf, last_leaf, self.curve
        )

        if grav:
            # vector-MAC halo augmentation from exact pool mass centers
            # (octree_focus_mpi.hpp:369-449 updateCenters + :601-610 addMacs)
            from ..focus.source_center import set_mac_radii, upsweep_centers
            from ..traversal.macs import mark_macs

            pool_m = pool_payload[4]
            w = jnp.abs(pool_m)
            sums = jnp.stack(
                [w * pool_payload[0], w * pool_payload[1], w * pool_payload[2], w],
                axis=-1,
            )
            leaf_acc = jax.ops.segment_sum(
                sums, pseg, num_segments=cap_leaf, indices_are_sorted=True
            )
            mass = leaf_acc[:, 3:4]
            inv = jnp.where(mass != 0, 1.0 / jnp.where(mass != 0, mass, 1.0), 1.0)
            leaf_centers = jnp.concatenate([leaf_acc[:, :3] * inv, mass], axis=-1)
            node_centers = upsweep_centers(linked, leaf_centers)
            centers4 = set_mac_radii(
                linked, node_centers, 1.0 / self.theta, box, self.curve
            )
            mac_marks = mark_macs(
                linked, centers4, box, focus_start, focus_end,
                linked.leaves, linked.n_leaf, limit_source=False, curve=self.curve,
            )
            mac_leaf = mac_marks[linked.leaf_order()]
            halo_flags = jnp.where(
                mine, halo_flags, halo_flags | mac_leaf.astype(halo_flags.dtype)
            )

        # ---- 7. local layout + buffer fill (layout.hpp:150-239) ------------
        layout = compute_node_layout(leaf_counts, halo_flags, first_leaf, last_leaf)
        n_with_halos = layout[cap_leaf]
        start_index = layout[first_leaf]
        end_index = layout[last_leaf]

        # local slot j -> pool index: leaf i = searchsorted(layout, j)-1,
        # pool idx = leaf_pool_off[i] + (j - layout[i])
        j = jnp.arange(cap, dtype=jnp.int32)
        leaf_of_j = segment_ids_from_offsets(layout, cap, cap_leaf)
        pool_idx = leaf_pool_off[leaf_of_j] + (j - layout[leaf_of_j])
        in_buffer = j < n_with_halos
        pool_idx = jnp.where(in_buffer, pool_idx, n_pool - 1)

        new_keys = jnp.where(in_buffer, pool_keys[pool_idx], rk)
        new_x = pool_payload[0][pool_idx]
        new_y = pool_payload[1][pool_idx]
        new_z = pool_payload[2][pool_idx]
        new_h = pool_payload[3][pool_idx]
        new_props = tuple(p[pool_idx] for p in pool_payload[4:])

        overflow = jnp.where(n_with_halos > cap, n_with_halos, 0).astype(jnp.int32)
        gcap = tree.keys.shape[0] - 1
        overflow = jnp.maximum(
            overflow, jnp.where(tree.n_nodes > gcap, tree.n_nodes, 0)
        )
        overflow = jnp.maximum(
            overflow, jnp.where(linked.n_leaf > cap_leaf, linked.n_leaf, 0)
        )
        overflow = jnp.maximum(overflow, focus_conv_ovf)

        new_state = DomainState(
            box=box,
            assignment=assignment,
            global_tree=tree,
            focus_leaves=linked.leaves,
            focus_n=linked.n_leaf,
            first_call=jnp.bool_(False),
            linked=linked,
            focus_converged=focus_converged,
        )
        result = SyncResult(
            keys=new_keys,
            x=new_x,
            y=new_y,
            z=new_z,
            h=new_h,
            properties=new_props,
            start_index=start_index,
            end_index=end_index,
            n_with_halos=n_with_halos,
            global_ids=pool_idx,
            sort_order=sort_order,
            pool_perm=pool_perm,
            layout=layout,
            halo_flags=halo_flags,
            tree=linked,
            leaf_counts=leaf_counts,
            overflow=overflow,
        )
        return new_state, result

    # ------------------------------------------------------------------
    def _common_assign(self, state, x, y, z, h, properties, n_local, boundaries):
        """Steps shared by both exchange modes: global box, key encode +
        local sort, global tree update, SFC assignment (call stack
        domain.hpp:197-243 steps 1-4)."""
        dt = self.key_dtype
        cap = x.shape[0]
        fdt = x.dtype
        rk = remove_key(dt)
        if n_local is None:
            n_local = jnp.int32(cap)
        n_local = jnp.asarray(n_local, jnp.int32)
        slot = jnp.arange(cap, dtype=jnp.int32)
        valid = slot < n_local

        props = tuple(properties)

        # ---- 1. global bounding box (box_mpi.hpp:85-119) -------------------
        big = fdt.type(np.finfo(fdt).max)
        xm = jnp.where(valid, x, big)
        ym = jnp.where(valid, y, big)
        zm = jnp.where(valid, z, big)
        xM = jnp.where(valid, x, -big)
        yM = jnp.where(valid, y, -big)
        zM = jnp.where(valid, z, -big)
        bnd = state.box.boundaries if boundaries is None else tuple(boundaries)
        if self.axis_name is None:
            mins = jnp.stack([jnp.min(xm), jnp.min(ym), jnp.min(zm)])
            maxs = jnp.stack([jnp.max(xM), jnp.max(yM), jnp.max(zM)])
        else:
            mins = jax.lax.pmin(
                jnp.stack([jnp.min(xm), jnp.min(ym), jnp.min(zm)]), self.axis_name
            )
            maxs = jax.lax.pmax(
                jnp.stack([jnp.max(xM), jnp.max(yM), jnp.max(zM)]), self.axis_name
            )
        # open-boundary dims may shrink at most 5% of the previous length
        # per step (limit_box_shrinking, box.hpp:415-431): one sparse step
        # can otherwise collapse the box and thrash the SFC assignment
        prev_mins = state.box.mins.astype(fdt)
        prev_maxs = state.box.maxs.astype(fdt)
        prev_len = prev_maxs - prev_mins
        shrink = fdt.type(0.05)
        limit_on = ~state.first_call
        mins = jnp.where(
            limit_on, jnp.minimum(mins, prev_mins + shrink * prev_len), mins
        )
        maxs = jnp.where(
            limit_on, jnp.maximum(maxs, prev_maxs - shrink * prev_len), maxs
        )
        # periodic/fixed dims keep previous limits unless first call
        keep = jnp.asarray([b != 0 for b in bnd])
        use_prev = keep & (~state.first_call)
        mins = jnp.where(use_prev, state.box.mins.astype(fdt), mins)
        maxs = jnp.where(use_prev, state.box.maxs.astype(fdt), maxs)
        # for periodic boundaries on first call, the caller-provided box is
        # authoritative; here we fit the particles (callers with periodic
        # boxes should pass an explicit box via init_state + set limits)
        limits = jnp.stack([mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2]])
        prev_limits = state.box.limits.astype(fdt)
        limits = jnp.where(
            state.first_call & jnp.any(jnp.asarray([b != 0 for b in bnd])),
            jnp.where(jnp.repeat(keep, 2), prev_limits, limits),
            limits,
        )
        box = Box(limits=limits, boundaries=bnd)

        # ---- 2. SFC keys + local sort (sfc.hpp:284, gather.hpp:158) --------
        keys = compute_sfc_keys(x, y, z, box, dt, self.curve)
        keys = jnp.where(valid, keys, rk)
        sorted_ = jax.lax.sort(
            (keys, slot, x, y, z, h) + props, num_keys=1, is_stable=True
        )
        keys = sorted_[0]
        sort_order = sorted_[1]  # SfcSorter map (primitives/gather.hpp:158)
        xs, ys, zs, hs = sorted_[2:6]
        props_s = sorted_[6:]

        # ---- 3. global tree update (update_mpi.hpp:48-104) -----------------
        tree, tree_changed = self._update_global_tree(state, keys, n_local)

        # ---- 4. assignment (domaindecomp.hpp:115-166) ----------------------
        assignment = make_sfc_assignment(
            tree.keys, tree.counts, tree.n_nodes, self.n_ranks
        )
        old_ok = ~state.first_call
        old = SfcAssignment(
            boundaries=jnp.where(
                old_ok, state.assignment.boundaries, assignment.boundaries
            ),
            counts=state.assignment.counts,
        )
        assignment = limit_boundary_shifts(old, assignment, tree.keys, tree.counts)
        return (box, keys, sort_order, xs, ys, zs, hs, props_s, tree,
                assignment, n_local, valid, tree_changed)

    # ------------------------------------------------------------------
    def _p2p_caps(self, cap: int):
        """Default p2p capacities derived from local capacity. Dense
        protocols interpret them as per-pair lane widths; ragged as
        per-rank TOTALS (surface-sized), so the defaults differ."""
        R = max(self.n_ranks, 1)
        move_cap = self.move_cap or max(64, (2 * cap) // R)
        if self.protocol == "ragged":
            treelet_cap = self.treelet_cap or max(256, self.focus_capacity)
            halo_req_cap = self.halo_req_cap or max(256, self.focus_capacity)
            halo_cap = self.halo_cap or max(256, 2 * cap)
        else:
            treelet_cap = self.treelet_cap or max(64, self.focus_capacity // 4)
            halo_req_cap = self.halo_req_cap or max(64, self.focus_capacity // 4)
            halo_cap = self.halo_cap or max(128, cap // 2)
        return move_cap, treelet_cap, halo_req_cap, halo_cap

    def _leaf_counts_service(
        self, leaves, n_leaf, owned_keys, n_owned, boundaries, q_cap,
        global_tree: Optional[CsArray] = None,
    ):
        """Per-leaf counts (updateCounts analog, octree_focus_mpi.hpp:
        205-273): local searchsorted for own cells, the peer count service
        for foreign cells. With peer_window set, only cells owned by ranks
        within the window are serviced exactly; cells beyond it take their
        counts from the global tree (rangeCount, rebalance.hpp:279-299 —
        far LET cells align with global cells, and where a transient
        misalignment occurs the enclosing-range sum overcounts, which can
        only delay a merge, never corrupt layout: layout counts are used
        only for own + halo cells, and halo owners are required to sit
        inside the window). Returns (counts, overflow)."""
        from ..parallel.exchange import range_count_service

        cap_leaf = leaves.shape[0] - 1
        me = jnp.asarray(self.rank, jnp.int32)
        li = jnp.arange(cap_leaf, dtype=jnp.int32)
        lvalid = li < n_leaf
        a = leaves[:-1]
        b = leaves[1:]

        pos = _searchsorted(owned_keys, leaves, side="left")
        pos = jnp.minimum(pos, jnp.asarray(n_owned, jnp.int32))
        local = (pos[1:] - pos[:-1]).astype(jnp.uint32)

        if self.n_ranks == 1:
            # every cell is local — no service round needed
            return jnp.where(lvalid, local, 0), jnp.int32(0)

        dest = (
            jnp.searchsorted(boundaries, a, side="right").astype(jnp.int32) - 1
        )
        dest = jnp.clip(dest, 0, self.n_ranks - 1)
        mine = dest == me
        W = self.peer_window or None
        if self.protocol == "ragged":
            from ..parallel.ragged import range_count_service_ragged

            foreign, ovf = range_count_service_ragged(
                a, b, dest, lvalid & (~mine), owned_keys, n_owned,
                self.n_ranks, q_cap, self.axis_name,
            )
        else:
            foreign, ovf = range_count_service(
                a, b, dest, lvalid & (~mine), owned_keys, n_owned,
                self.n_ranks, q_cap, self.axis_name,
                my_rank=me, window=W,
            )
        counts = jnp.where(mine & lvalid, local, foreign.astype(jnp.uint32))
        if W is not None and global_tree is not None:
            far = lvalid & (~mine) & (jnp.abs(dest - me) > W)
            counts = jnp.where(
                far,
                self._global_range_counts(global_tree, a, b),
                counts,
            )
        return jnp.where(lvalid, counts, 0), ovf

    def _global_range_counts(self, tree: CsArray, a, b):
        """Counts of [a, b) key ranges summed from the global tree
        (rangeCount, focus/rebalance.hpp:279-299). Exact when the range
        aligns with global cell boundaries; otherwise the enclosing-range
        sum (findNodeBelow/findNodeAbove semantics) overcounts."""
        n_nodes = tree.n_nodes
        gkeys = tree.keys
        gi = jnp.arange(tree.counts.shape[0], dtype=jnp.int32)
        gcounts = jnp.where(gi < n_nodes, tree.counts, 0)
        csum = jnp.concatenate(
            [jnp.zeros((1,), jnp.uint32), jnp.cumsum(gcounts, dtype=jnp.uint32)]
        )
        i0 = _searchsorted(gkeys, a, side="right").astype(jnp.int32) - 1
        i1 = _searchsorted(gkeys, b, side="left").astype(jnp.int32)
        i0 = jnp.clip(i0, 0, n_nodes)
        i1 = jnp.clip(i1, i0, n_nodes)
        return csum[i1] - csum[i0]

    def _expansion_centers(
        self, linked, okeys, ox, oy, oz, om, n_owned, boundaries,
        treelet_cap, box,
    ):
        """Exact global mass centers + squared vector-MAC radii per focus
        node (updateCenters + setMacRadius, octree_focus_mpi.hpp:369-531):
        own leaves from local owned particles, foreign leaves via the
        range-sum service (the globalFocusExchange analog) — scoped to the
        peer window when one is set; cells beyond the window are non-peers
        by the MAC criterion, so their zero-mass placeholder centers never
        participate in halo discovery. Returns (centers (n_nodes, 4) —
        x, y, z, mass; mac_spheres (n_nodes, 4) — x, y, z, squared
        vector-MAC radius; overflow)."""
        from ..focus.source_center import set_mac_radii, upsweep_centers
        from ..parallel.exchange import range_sum_service

        cap = okeys.shape[0]
        cap_leaf = linked.leaves.shape[0] - 1
        my_rank = jnp.asarray(self.rank, jnp.int32)
        li = jnp.arange(cap_leaf, dtype=jnp.int32)

        w = jnp.abs(om)
        vals = jnp.stack([w * ox, w * oy, w * oz, w], axis=-1)
        leaf_off = _searchsorted(okeys, linked.leaves, side="left")
        leaf_off = jnp.minimum(leaf_off, jnp.asarray(n_owned, jnp.int32))
        pseg = segment_ids_from_offsets(leaf_off, cap, cap_leaf)
        ow_valid = (jnp.arange(cap, dtype=jnp.int32) < n_owned)[:, None]
        leaf_acc_local = jax.ops.segment_sum(
            jnp.where(ow_valid, vals, 0.0), pseg,
            num_segments=cap_leaf, indices_are_sorted=True,
        )
        if self.n_ranks == 1:
            leaf_acc = leaf_acc_local
            sum_ovf = jnp.int32(0)
        else:
            a = linked.leaves[:-1]
            b = linked.leaves[1:]
            dest = (
                jnp.searchsorted(boundaries, a, side="right")
                .astype(jnp.int32) - 1
            )
            dest = jnp.clip(dest, 0, self.n_ranks - 1)
            lvalid = li < linked.n_leaf
            if self.protocol == "ragged":
                from ..parallel.ragged import range_sum_service_ragged

                foreign_sums, sum_ovf = range_sum_service_ragged(
                    a, b, dest, lvalid & (dest != my_rank), okeys, n_owned,
                    vals, self.n_ranks, treelet_cap, self.axis_name,
                )
            else:
                foreign_sums, sum_ovf = range_sum_service(
                    a, b, dest, lvalid & (dest != my_rank), okeys, n_owned,
                    vals, self.n_ranks, treelet_cap, self.axis_name,
                    my_rank=my_rank, window=self.peer_window or None,
                )
            leaf_acc = jnp.where(
                (dest == my_rank)[:, None], leaf_acc_local, foreign_sums
            )
        mass = leaf_acc[:, 3:4]
        inv = jnp.where(mass != 0, 1.0 / jnp.where(mass != 0, mass, 1.0), 1.0)
        leaf_centers = jnp.concatenate([leaf_acc[:, :3] * inv, mass], axis=-1)
        node_centers = upsweep_centers(linked, leaf_centers)
        centers4 = set_mac_radii(
            linked, node_centers, 1.0 / self.theta, box, self.curve
        )
        return node_centers, centers4, sum_ovf

    def update_expansion_centers(
        self, state: DomainState, result: SyncResult, m: jax.Array
    ):
        """Public expansion-center maintenance between syncs — the
        reference's focusTree.updateCenters + setMacRadius + updateMacs
        sequence (octree_focus_mpi.hpp:369-531) exposed without grav=True,
        so gravity clients can refresh multipole acceptance data after
        mass/position updates that don't warrant a full sync.

        m: (local_capacity,) mass in the result's layout order (e.g. a
        synced property or a reapply_sync'd field; halo slots are ignored
        — foreign cells are summed exactly by their owners).

        Returns (centers (n_nodes, 4) — x, y, z, mass per focus node;
        mac_spheres (n_nodes, 4) — x, y, z and the squared vector-MAC
        radius (setMacRadius form); mac_flags (cap_leaf,) int32 leaf
        MAC-failure flags relative to my focus range; overflow int32).
        Call inside shard_map when n_ranks > 1.
        """
        from ..traversal.macs import mark_macs

        linked = result.tree
        cap = result.keys.shape[0]
        j = jnp.arange(cap, dtype=jnp.int32)
        take = jnp.clip(result.start_index + j, 0, cap - 1)
        n_owned = result.end_index - result.start_index
        rk = remove_key(self.key_dtype)
        okeys = jnp.where(j < n_owned, result.keys[take], rk)
        zero = result.x.dtype.type(0)
        ox = jnp.where(j < n_owned, result.x[take], zero)
        oy = jnp.where(j < n_owned, result.y[take], zero)
        oz = jnp.where(j < n_owned, result.z[take], zero)
        om = jnp.where(j < n_owned, m[take], m.dtype.type(0))

        _, treelet_cap, _, _ = self._p2p_caps(cap)
        boundaries = state.assignment.boundaries
        my_rank = jnp.asarray(self.rank, jnp.int32)
        centers, mac_spheres, ovf = self._expansion_centers(
            linked, okeys, ox, oy, oz, om, n_owned, boundaries,
            treelet_cap, state.box,
        )
        mac_marks = mark_macs(
            linked, mac_spheres, state.box,
            boundaries[my_rank], boundaries[my_rank + 1],
            linked.leaves, linked.n_leaf, limit_source=False,
            curve=self.curve,
        )
        return centers, mac_spheres, mac_marks[linked.leaf_order()], ovf

    # ------------------------------------------------------------------
    def _sync_p2p(
        self, state, x, y, z, h, properties, n_local, boundaries, grav
    ) -> Tuple[DomainState, SyncResult]:
        """Peer-local sync: all communication is O(local+surface) per rank.

        Step order mirrors Domain::sync (domain.hpp:197-243): assign ->
        exchangeParticles -> focus tree -> counts -> halo discovery ->
        layout -> halo exchange of x/y/z/h(+props), with the reference's
        sparse MPI protocols realized as all_to_all rounds
        (parallel/exchange.py).
        """
        from ..focus.octree_focus import focus_converge
        from ..parallel.exchange import (
            build_halo_exchange,
            exchange_halo_field,
            exchange_particles,
        )
        from ..traversal.macs import inv_theta_min_mac, inv_theta_vec_mac

        dt = self.key_dtype
        cap = x.shape[0]
        fdt = x.dtype
        rk = remove_key(dt)
        move_cap, treelet_cap, halo_req_cap, halo_cap = self._p2p_caps(cap)

        (box, keys, sort_order, xs, ys, zs, hs, props_s, tree, assignment,
         n_local, valid, tree_changed) = self._common_assign(
            state, x, y, z, h, properties, n_local, boundaries
        )

        # ---- 5. particle exchange (domaindecomp_mpi.hpp:104-158) -----------
        my_rank = jnp.asarray(self.rank, jnp.int32)
        single = self.n_ranks == 1
        if single:
            # one rank owns everything: the sorted arrays ARE the owned set
            okeys, opayload, ex = keys, (xs, ys, zs, hs) + props_s, None
            n_owned = n_local
            overflow = jnp.int32(0)
            move_ovf = jnp.int32(0)
        else:
            okeys, opayload, ex = exchange_particles(
                keys, (xs, ys, zs, hs) + props_s, assignment.boundaries,
                my_rank, n_local, move_cap, self.axis_name,
            )
            n_owned = ex.n_owned
            overflow = ex.overflow
            move_ovf = ex.overflow
        ox, oy, oz, oh = opayload[:4]
        oprops = opayload[4:]

        # ---- 6. focused octree (LET) with service counts -------------------
        _itm = inv_theta_vec_mac if grav else inv_theta_min_mac
        focus_start = assignment.boundaries[my_rank]
        focus_end = assignment.boundaries[my_rank + 1]

        # Single-rank + equal bucket sizes: the focus tree's fixed point IS
        # the global cornerstone tree (the whole domain is inside the focus,
        # MACs never fire, and both trees refine/merge on the same
        # count-vs-bucket rule), so the converge loop — with its extra
        # count pass and rebalance machinery — is redundant. Mirror the
        # global tree and reuse its counts (octree_focus.hpp:83-153
        # degenerate case).
        fast_focus = (
            single
            and self.bucket_size_focus == self.bucket_size
            and state.focus_leaves.shape[0] == tree.keys.shape[0]
        )
        if fast_focus:
            # warm steps where the rebalance decision reported "converged"
            # reuse last step's linked structure — the leaf array is
            # bit-identical, only counts changed (rebalanceStatus guard,
            # octree_focus_mpi.hpp:669-677); saves the full one-pass build
            linked = jax.lax.cond(
                tree_changed | state.first_call,
                lambda: build_linked_octree(tree.keys, tree.n_nodes),
                lambda: state.linked,
            )
            cap_leaf = linked.leaves.shape[0] - 1
            lif = jnp.arange(cap_leaf, dtype=jnp.int32)
            leaf_counts = jnp.where(
                lif < linked.n_leaf, tree.counts, jnp.uint32(0)
            )
            focus_conv_ovf = jnp.int32(0)
            svc_ovf = jnp.int32(0)
            focus_converged = ~tree_changed
        else:
            def counts_fn(leaves, n_leaf):
                return self._leaf_counts_service(
                    leaves, n_leaf, okeys, n_owned, assignment.boundaries,
                    treelet_cap, global_tree=tree,
                )

            (_, _, linked, node_counts_f, focus_conv_ovf, svc_ovf,
             focus_converged) = focus_converge(
                state.focus_leaves,
                state.focus_n,
                None,
                None,
                box,
                focus_start,
                focus_end,
                assignment.boundaries,
                self.bucket_size_focus,
                _itm(self.theta),
                axis_name=self.axis_name,
                curve=self.curve,
                leaf_counts_fn=counts_fn,
                skip_macs=single,
                linked0=state.linked,
                use_carried=state.focus_converged & ~state.first_call,
            )
            cap_leaf = linked.leaves.shape[0] - 1

            # leaf counts come from the converge loop's final count pass —
            # one count-service round per sync total (the reference likewise
            # shares updateTree's counts with updateCounts,
            # octree_focus_mpi.hpp:108-273)
            lif = jnp.arange(cap_leaf, dtype=jnp.int32)
            leaf_counts = jnp.where(
                lif < linked.n_leaf, node_counts_f[linked.leaf_order()], jnp.uint32(0)
            )
        overflow = jnp.maximum(overflow, svc_ovf)

        first_leaf = _searchsorted(linked.leaves, focus_start, side="left")[()]
        last_leaf = _searchsorted(linked.leaves, focus_end, side="left")[()]

        # ---- 7. per-leaf interaction radii from OWNED particles ------------
        leaf_off = _searchsorted(okeys, linked.leaves, side="left")
        leaf_off = jnp.minimum(leaf_off, n_owned)
        pseg = segment_ids_from_offsets(leaf_off, cap, cap_leaf)
        oh_valid = jnp.where(jnp.arange(cap, dtype=jnp.int32) < n_owned, oh, 0.0)
        leaf_hmax = jax.ops.segment_max(
            oh_valid, pseg, num_segments=cap_leaf, indices_are_sorted=True
        )
        leaf_hmax = jnp.maximum(leaf_hmax, 0.0)
        li = jnp.arange(cap_leaf, dtype=jnp.int32)
        mine_leaf = (li >= first_leaf) & (li < last_leaf)
        radii = jnp.where(
            mine_leaf, leaf_hmax * fdt.type(2.0 * self.halo_search_ext), 0.0
        )

        if single:
            # one rank: every leaf is in the own assignment, so halo
            # discovery cannot flag anything — skip the collision
            # traversal (collisions.hpp:79-105 degenerate case)
            halo_flags = jnp.zeros((cap_leaf,), jnp.int32)
        else:
            halo_flags = find_halos(
                linked, radii, box, first_leaf, last_leaf, self.curve
            )

        if grav and not single:
            # vector-MAC halo augmentation from exact mass centers: own
            # cells local, peer cells via the sum service (updateCenters,
            # octree_focus_mpi.hpp:369-449 + addMacs :601-610)
            from ..traversal.macs import mark_macs

            _, centers4, sum_ovf = self._expansion_centers(
                linked, okeys, ox, oy, oz, oprops[0], n_owned,
                assignment.boundaries, treelet_cap, box,
            )
            overflow = jnp.maximum(overflow, sum_ovf)
            mac_marks = mark_macs(
                linked, centers4, box, focus_start, focus_end,
                linked.leaves, linked.n_leaf, limit_source=False,
                curve=self.curve,
            )
            mac_leaf = mac_marks[linked.leaf_order()]
            halo_flags = jnp.where(
                mine_leaf, halo_flags, halo_flags | mac_leaf.astype(halo_flags.dtype)
            )

        # ---- 8. layout (layout.hpp:150-164) --------------------------------
        layout = compute_node_layout(leaf_counts, halo_flags, first_leaf, last_leaf)
        n_with_halos = layout[cap_leaf]
        start_index = layout[first_leaf]
        end_index = layout[last_leaf]
        overflow = jnp.maximum(
            overflow, jnp.where(n_with_halos > cap, n_with_halos, 0)
        )

        # ---- 9. place owned particles at [start_index, end_index) ----------
        j = jnp.arange(cap, dtype=jnp.int32)
        tgt = jnp.where(j < n_owned, start_index + j, cap)

        if single:
            # no halos -> start_index == 0 and the layout order IS the
            # sorted order: placement is the identity (five scatters
            # skipped)
            def place(owned, fill):
                return owned
        else:
            def place(owned, fill):
                buf = jnp.full((cap,), fill, owned.dtype)
                return buf.at[tgt].set(owned, mode="drop")

        new_x = place(ox, fdt.type(0))
        new_y = place(oy, fdt.type(0))
        new_z = place(oz, fdt.type(0))
        new_h = place(oh, fdt.type(0))
        new_props = tuple(place(p, p.dtype.type(0)) for p in oprops)

        # ---- 10. halo exchange of x, y, z, h (+props) -----------------------
        win_need = jnp.int32(0)
        if single:
            halo_rec = None
            halo_ovf = jnp.int32(0)
            in_buf = j < n_with_halos
            new_keys = jnp.where(in_buf, okeys, rk)
        else:
            dest_leaf = (
                jnp.searchsorted(
                    assignment.boundaries, linked.leaves[:-1], side="right"
                ).astype(jnp.int32) - 1
            )
            dest_leaf = jnp.clip(dest_leaf, 0, self.n_ranks - 1)
            lvalid = li < linked.n_leaf
            halo_req = (halo_flags.astype(bool)) & (~mine_leaf) & lvalid
            W = self.peer_window or None
            if W is not None:
                # the exactness domain of the windowed protocols must cover
                # every halo owner AND every MAC-relevant peer
                # (peers.hpp:63-117); report the max offset actually needed
                # so sync_with_retry can grow the window capacity
                off = jnp.abs(dest_leaf - my_rank)
                win_need = jnp.max(jnp.where(halo_req, off, 0)).astype(jnp.int32)
                peers = find_peers_mac(
                    my_rank, assignment, linked, box,
                    _itm(self.theta), self.curve,
                )
                r_ids = jnp.arange(self.n_ranks, dtype=jnp.int32)
                peer_off = jnp.where(peers > 0, jnp.abs(r_ids - my_rank), 0)
                win_need = jnp.maximum(win_need, jnp.max(peer_off).astype(jnp.int32))
                win_need = jnp.where(win_need > W, win_need, 0)
            if self.protocol == "ragged":
                from ..parallel.ragged import build_halo_exchange_ragged

                halo_rec = build_halo_exchange_ragged(
                    linked.leaves[:-1], linked.leaves[1:], leaf_counts,
                    layout, halo_req, dest_leaf, okeys, n_owned,
                    self.n_ranks, halo_req_cap, halo_cap, self.axis_name,
                )
            else:
                halo_rec = build_halo_exchange(
                    linked.leaves[:-1], linked.leaves[1:], leaf_counts, layout,
                    halo_req, dest_leaf, okeys, n_owned, self.n_ranks,
                    halo_req_cap, halo_cap, self.axis_name,
                    my_rank=my_rank, window=W,
                )
            halo_ovf = halo_rec.overflow
            overflow = jnp.maximum(overflow, halo_rec.overflow)

            hx = self._halo_field
            new_x = hx(ox, new_x, halo_rec)
            new_y = hx(oy, new_y, halo_rec)
            new_z = hx(oz, new_z, halo_rec)
            new_h = hx(oh, new_h, halo_rec)
            new_props = tuple(
                hx(op, np_buf, halo_rec)
                for op, np_buf in zip(oprops, new_props)
            )

            # halo keys recomputed from coordinates (domain.hpp:523-540)
            in_buf = j < n_with_halos
            new_keys = compute_sfc_keys(new_x, new_y, new_z, box, dt, self.curve)
            new_keys = jnp.where(in_buf, new_keys, rk)
            owned_slots = (j >= start_index) & (j < end_index)
            okeys_placed = place(okeys, rk)
            new_keys = jnp.where(owned_slots, okeys_placed, new_keys)

        gcap = tree.keys.shape[0] - 1
        tree_ovf = jnp.where(tree.n_nodes > gcap, tree.n_nodes, 0)
        focus_ovf = jnp.maximum(
            jnp.where(linked.n_leaf > cap_leaf, linked.n_leaf, 0),
            focus_conv_ovf,
        )
        local_ovf = jnp.where(n_with_halos > cap, n_with_halos, 0)
        overflow = jnp.maximum(overflow, jnp.maximum(tree_ovf, focus_ovf))
        overflow = jnp.maximum(overflow, win_need)
        detail = jnp.stack([
            local_ovf.astype(jnp.int32),
            tree_ovf.astype(jnp.int32),
            focus_ovf.astype(jnp.int32),
            jnp.asarray(move_ovf, jnp.int32),
            jnp.asarray(svc_ovf, jnp.int32),
            jnp.asarray(halo_ovf, jnp.int32),
            win_need,
        ])
        if self.axis_name is not None:
            overflow = jax.lax.pmax(overflow, self.axis_name)
            detail = jax.lax.pmax(detail, self.axis_name)

        new_state = DomainState(
            box=box,
            assignment=assignment,
            global_tree=tree,
            focus_leaves=linked.leaves,
            focus_n=linked.n_leaf,
            first_call=jnp.bool_(False),
            linked=linked,
            focus_converged=focus_converged,
        )
        result = SyncResult(
            keys=new_keys,
            x=new_x,
            y=new_y,
            z=new_z,
            h=new_h,
            properties=new_props,
            start_index=start_index,
            end_index=end_index,
            n_with_halos=n_with_halos,
            global_ids=None,
            sort_order=sort_order,
            pool_perm=None,
            layout=layout,
            halo_flags=halo_flags,
            tree=linked,
            leaf_counts=leaf_counts,
            overflow=overflow.astype(jnp.int32),
            ex_record=ex,
            halo_record=halo_rec,
            overflow_detail=detail,
        )
        return new_state, result

    # ------------------------------------------------------------------
    def _update_global_tree(self, state: DomainState, keys, n_local) -> CsArray:
        from ..tree.csarray import rebalance_decision, rebalance_tree

        max_count = np.uint32(0xFFFFFFFF // max(1, self.n_ranks) - 1)

        def count(t_keys):
            local = compute_node_counts(t_keys, keys, max_count, n_local)
            return self._psum(local)

        tree0 = state.global_tree
        tree0 = CsArray(
            keys=tree0.keys, counts=count(tree0.keys), n_nodes=tree0.n_nodes
        )
        capacity = tree0.keys.shape[0] - 1

        # decision-first loop: a warm (already converged) tree costs one
        # count + one decision; the rebalance + recount only run when the
        # decision actually changed the tree (csarray.hpp:411-448)
        ops0, conv0 = rebalance_decision(
            tree0.keys, tree0.counts, tree0.n_nodes, self.bucket_size
        )

        def cond(s):
            _, _, stop = s
            return ~stop

        def body(s):
            t, ops, _ = s
            nk, nn = rebalance_tree(t.keys, ops, t.n_nodes)
            nc = count(nk)
            t2 = CsArray(keys=nk, counts=nc, n_nodes=nn)
            ops2, conv2 = rebalance_decision(nk, nc, nn, self.bucket_size)
            return t2, ops2, conv2 | (nn > capacity)

        tree, _, _ = jax.lax.while_loop(cond, body, (tree0, ops0, conv0))
        # conv0 == True means the warm tree's leaf array is already the
        # fixed point: keys are bit-identical to state.global_tree.keys and
        # downstream linked structure can be reused (csarray.hpp:430-448
        # convergence short-circuit)
        return tree, ~conv0

    # ------------------------------------------------------------------
    def _halo_field(self, owned_sorted, local_buf, rec) -> jax.Array:
        """Route one field's halo move through the record's protocol."""
        from ..parallel.exchange import exchange_halo_field
        from ..parallel.ragged import RaggedHaloRecord, exchange_halo_field_ragged

        if isinstance(rec, RaggedHaloRecord):
            return exchange_halo_field_ragged(
                owned_sorted, local_buf, rec, self.axis_name
            )
        return exchange_halo_field(owned_sorted, local_buf, rec, self.axis_name)

    def exchange_halos(self, result: SyncResult, prop: jax.Array) -> jax.Array:
        """Fill halo slots of `prop` with values from their owner ranks
        (domain.hpp:382-386, halos.hpp:224-251).

        prop: (local_capacity,) values valid in [start_index, end_index).
        Returns prop with halo slots filled.
        """
        cap = prop.shape[0]
        j = jnp.arange(cap, dtype=jnp.int32)
        if self.n_ranks == 1 and result.halo_record is None and result.global_ids is None:
            return prop  # single rank: there are no halo slots
        if result.halo_record is not None:
            # owned region in layout order IS the owned-sorted order
            owned_sorted = prop[
                jnp.clip(result.start_index + j, 0, cap - 1)
            ]
            return self._halo_field(owned_sorted, prop, result.halo_record)
        owned = (j >= result.start_index) & (j < result.end_index)

        n_pool = cap * (self.n_ranks if self.axis_name is not None else 1)
        pool_vals = jnp.zeros((n_pool,), dtype=prop.dtype)
        tgt = jnp.where(owned, result.global_ids, n_pool)
        pool_vals = pool_vals.at[tgt].set(prop, mode="drop")
        pool_vals = self._psum(pool_vals)
        return pool_vals[result.global_ids]

    # ------------------------------------------------------------------
    def diagnostics(self, state: DomainState, result: SyncResult) -> dict:
        """Per-rank focus/halo statistics (domain.hpp:606-652). Host-side.

        Includes MAC peer discovery (findPeersMac, peers.hpp:63-117) on
        every protocol — the dense/windowed path uses the peer set for
        routing, the ragged path only for sizing, but the peer count and
        max rank offset are load-balance observables either way."""
        import numpy as np_

        from ..traversal.macs import inv_theta_min_mac
        from ..traversal.peers import find_peers_mac

        n_leaf = int(result.tree.n_leaf)
        flags = np_.asarray(result.halo_flags[:n_leaf])
        diag = {
            "focus_leaves": n_leaf,
            "focus_nodes": int(result.tree.n_nodes),
            "global_leaves": int(state.global_tree.n_nodes),
            "halo_cells": int(flags.sum()),
            "assigned_particles": int(result.end_index) - int(result.start_index),
            "particles_with_halos": int(result.n_with_halos),
            "overflow": int(result.overflow),
            "box": np_.asarray(state.box.limits).tolist(),
        }
        if self.n_ranks > 1:
            peers = np_.asarray(
                find_peers_mac(
                    jnp.asarray(self.rank, jnp.int32), state.assignment,
                    result.tree, state.box,
                    inv_theta_min_mac(self.theta), self.curve,
                )
            )
            offs = np_.abs(np_.arange(self.n_ranks) - self.rank)
            diag["mac_peers"] = int((peers > 0).sum())
            diag["mac_peer_max_offset"] = int(offs[peers > 0].max()) if (
                peers > 0
            ).any() else 0
        return diag

    # ------------------------------------------------------------------
    def reapply_sync(self, result: SyncResult, prop: jax.Array) -> jax.Array:
        """Replay the sync exchange for an extra field (domain.hpp:335-378).

        prop: (local_capacity,) values in the PRE-sync local particle order.
        Returns the field in post-sync layout order (halo slots zero in p2p
        mode, matching the reference where extra fields' halos are filled
        on demand via exchangeHalos). The replay is deterministic by
        construction (the recorded permutations replace the reference's
        ExchangeLog, index_ranges.hpp:188-211).
        """
        sorted_prop = prop[result.sort_order]
        if self.n_ranks == 1 and result.ex_record is None and result.pool_perm is None:
            # single-rank p2p: layout order == sorted order, start_index 0
            return sorted_prop
        if result.ex_record is not None:
            from ..parallel.exchange import replay_exchange

            owned = replay_exchange(sorted_prop, result.ex_record, self.axis_name)
            cap = prop.shape[0]
            j = jnp.arange(cap, dtype=jnp.int32)
            tgt = jnp.where(j < result.ex_record.n_owned, result.start_index + j, cap)
            return jnp.zeros((cap,), prop.dtype).at[tgt].set(owned, mode="drop")
        pool = self._pgather(sorted_prop).reshape(-1)
        pool = pool[result.pool_perm]
        return pool[result.global_ids]

    # ------------------------------------------------------------------
    @staticmethod
    def compact_owned(result: SyncResult, field: jax.Array) -> jax.Array:
        """Move the owned range [start_index, end_index) to the front.

        The output is the correct per-rank input for the NEXT sync call
        (with n_local = end_index - start_index): feeding layout-order
        buffers back with their halo slots would double-count halo
        particles as locally owned. The reference keeps explicit
        start/end indices instead (domain.hpp:389-409); here a dynamic
        roll keeps the shape static.
        """
        return jnp.roll(field, -result.start_index, axis=0)

    # ------------------------------------------------------------------
    def ns_view(self, result: SyncResult, box: Box) -> OctreeNsView:
        """Neighbor-search view over the local buffers (domain.hpp:425-437)."""
        return make_ns_view(
            result.tree, result.layout, box, self.curve,
            search_ext_factor=self.halo_search_ext,
        )
