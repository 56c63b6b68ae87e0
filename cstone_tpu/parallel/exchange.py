"""Peer-local communication primitives: particle exchange, range queries.

JAX replacement for the reference's sparse MPI point-to-point
protocols (reference: domain/domaindecomp_mpi.hpp:104-158 exchangeParticles,
domain/exchange_keys.hpp:63-119 exchangeRequestKeys, halos/
exchange_halos.hpp:28-93, focus/exchange_focus.hpp:290-344
exchangeTreeletGeneral). Dynamic message sizes and MPI_Probe become
static-shaped `jax.lax.all_to_all` buffers over the rank axis: each
protocol round is one all_to_all of a (n_ranks, cap) buffer, with per-pair
validity masks and overflow flags replacing dynamic sizes. Per-rank memory
and communication volume are proportional to local+surface data (times a
padding factor), independent of the global particle count — unlike the
round-1 all_gather pool.

Everything here must run inside shard_map with `axis_name` bound (or with
axis_name=None for the single-rank degenerate case, where all_to_all is the
identity).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.primitives import searchsorted as _searchsorted
from ..sfc.keys import remove_key

__all__ = [
    "all_to_all",
    "windowed_exchange",
    "dest_to_window_row",
    "pack_by_dest",
    "ExchangeRecord",
    "exchange_particles",
    "replay_exchange",
    "range_count_service",
    "range_sum_service",
    "HaloRecord",
    "build_halo_exchange",
    "exchange_halo_field",
]


def all_to_all(x: jax.Array, axis_name: Optional[str]) -> jax.Array:
    """Row r of the result = row `me` of rank r's input. Identity when
    axis_name is None (single-rank)."""
    if axis_name is None:
        return x
    return jax.lax.all_to_all(x, axis_name, split_axis=0, concat_axis=0, tiled=True)


def windowed_exchange(
    buf: jax.Array, axis_name: Optional[str], window: int, n_ranks: int
) -> jax.Array:
    """Peer-window counterpart of all_to_all (reference: the peer-scoped
    P2P sends of exchange_focus.hpp:62-96 / exchange_keys.hpp:63-119,
    bounded by findPeersMac, peers.hpp:63-117).

    buf is (2*window+1, ...): row w holds the message for rank
    me + (w - window). Returns the same shape where row w holds the
    message FROM rank me + (w - window); rows whose source rank is out of
    [0, n_ranks) are zero. Per-rank memory and traffic are O(window), not
    O(n_ranks): each offset d rides one ppermute pair over the rank axis
    (SFC-surface peers sit at small rank offsets because rank order IS
    curve order).
    """
    W = int(window)
    assert buf.shape[0] == 2 * W + 1
    if axis_name is None or n_ranks == 1:
        return buf
    out = jnp.zeros_like(buf)
    out = out.at[W].set(buf[W])  # self
    R = n_ranks
    for d in range(1, W + 1):
        if d >= R:
            break
        # my row W+d (for rank me+d) travels +d; it arrives at me+d as the
        # message from offset -d, i.e. their row W-d — and vice versa.
        fwd = [(r, r + d) for r in range(R - d)]
        bwd = [(r, r - d) for r in range(d, R)]
        out = out.at[W - d].set(jax.lax.ppermute(buf[W + d], axis_name, fwd))
        out = out.at[W + d].set(jax.lax.ppermute(buf[W - d], axis_name, bwd))
    return out


def dest_to_window_row(
    dest: jax.Array, my_rank, window: int, n_ranks: int
) -> Tuple[jax.Array, jax.Array]:
    """(row, in_window): window-buffer row index for each destination rank
    and whether it fits the window. Rows for out-of-window destinations
    alias row 0 and must be masked by the caller."""
    me = jnp.asarray(my_rank, jnp.int32)
    off = dest.astype(jnp.int32) - me
    in_win = (jnp.abs(off) <= window) & (dest >= 0) & (dest < n_ranks)
    return jnp.where(in_win, off + window, 0), in_win


def pack_by_dest(
    dest: jax.Array,  # (Q,) int32 destination rank per item, NONDECREASING
    valid: jax.Array,  # (Q,) bool
    n_ranks: int,
) -> Tuple[jax.Array, jax.Array]:
    """(row, col) scatter coordinates packing items into (n_ranks, cap).

    Items must be sorted by destination (true for SFC-ordered cells/leaves,
    whose owner rank is monotonic along the curve); invalid items may be
    interleaved anywhere. col is the item's index within its destination
    row counting valid items only. Invalid items get row n_ranks (dropped
    by mode='drop' scatters).
    """
    # first occurrence per destination on the RAW (monotonic) dest; col =
    # number of VALID items of the same dest before this one
    vcum_ex = jnp.cumsum(valid.astype(jnp.int32)) - valid.astype(jnp.int32)
    first = jnp.searchsorted(dest, dest, side="left").astype(jnp.int32)
    col = vcum_ex - vcum_ex[first]
    row = jnp.where(valid, dest, n_ranks)
    return row, col


# ---------------------------------------------------------------------------
# particle exchange (domaindecomp_mpi.hpp:104-158 analog)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ExchangeRecord:
    """Deterministic replay record for one particle exchange — the analog of
    the reference's ExchangeLog (domain/index_ranges.hpp:188-211), except
    that replay is exact by construction (all_to_all order is fixed)."""

    send_idx: jax.Array  # (R, move_cap) int32 gather into pre-exchange sorted arrays
    send_valid: jax.Array  # (R, move_cap) bool
    merge_perm: jax.Array  # (cap + R*move_cap,) int32 sort permutation
    n_owned: jax.Array  # int32 valid particles after exchange
    overflow: jax.Array  # int32 > 0 if move_cap or cap exceeded


def exchange_particles(
    keys: jax.Array,  # (cap,) locally sorted keys; invalid slots = removeKey
    payload: Sequence[jax.Array],  # (cap,) fields in the same order
    boundaries: jax.Array,  # (R+1,) assignment key boundaries
    my_rank,
    n_local,
    move_cap: int,
    axis_name: Optional[str],
) -> Tuple[jax.Array, Tuple[jax.Array, ...], ExchangeRecord]:
    """Redistribute particles to their assigned ranks.

    Every rank slices its sorted keys by the assignment boundaries, sends
    each foreign slice to its owner through one all_to_all of a
    (R, move_cap) buffer per field, and merge-sorts kept + received
    particles. Returns (new_keys, new_payload, record); new arrays have the
    same capacity, with slots >= record.n_owned carrying removeKey.

    Cost per rank: O(cap + R*move_cap) memory and compute; move_cap bounds
    the largest single-destination transfer (grow + re-jit on overflow, the
    reference's reallocate policy, util/reallocate.hpp:38-107).
    """
    cap = keys.shape[0]
    dt = keys.dtype
    rk = remove_key(dt)
    R = boundaries.shape[0] - 1
    me = jnp.asarray(my_rank, jnp.int32)
    n_local = jnp.asarray(n_local, jnp.int32)

    offs = _searchsorted(keys, boundaries, side="left")
    offs = jnp.minimum(offs, n_local).astype(jnp.int32)  # (R+1,)
    counts = offs[1:] - offs[:-1]
    r_ids = jnp.arange(R, dtype=jnp.int32)
    send_counts = jnp.where(r_ids == me, 0, counts)
    overflow = jnp.where(
        jnp.max(send_counts) > move_cap, jnp.max(send_counts), 0
    ).astype(jnp.int32)

    k = jnp.arange(move_cap, dtype=jnp.int32)
    send_valid = k[None, :] < send_counts[:, None]  # (R, move_cap)
    send_idx = jnp.clip(offs[:-1, None] + k[None, :], 0, cap - 1)
    send_idx = jnp.where(send_valid, send_idx, cap - 1)

    send_keys = jnp.where(send_valid, keys[send_idx], rk)
    recv_keys = all_to_all(send_keys, axis_name)  # (R, move_cap)

    slot = jnp.arange(cap, dtype=jnp.int32)
    kept = (slot >= offs[me]) & (slot < offs[me + 1])
    kept_keys = jnp.where(kept, keys, rk)

    all_keys = jnp.concatenate([kept_keys, recv_keys.reshape(-1)])
    iota = jnp.arange(all_keys.shape[0], dtype=jnp.int32)
    payload = tuple(payload)
    all_payload = tuple(
        jnp.concatenate([p, all_to_all(p[send_idx], axis_name).reshape(-1)])
        for p in payload
    )
    sorted_ = jax.lax.sort(
        (all_keys, iota) + all_payload, num_keys=1, is_stable=True
    )
    merge_perm = sorted_[1]
    new_keys = sorted_[0][:cap]
    new_payload = tuple(p[:cap] for p in sorted_[2:])

    n_owned = jnp.sum(all_keys != rk, dtype=jnp.int32)
    overflow = jnp.maximum(
        overflow, jnp.where(n_owned > cap, n_owned, 0).astype(jnp.int32)
    )

    rec = ExchangeRecord(
        send_idx=send_idx,
        send_valid=send_valid,
        merge_perm=merge_perm,
        n_owned=n_owned,
        overflow=overflow,
    )
    return new_keys, new_payload, rec


def replay_exchange(
    prop: jax.Array,  # (cap,) field in pre-exchange SORTED order
    rec: ExchangeRecord,
    axis_name: Optional[str],
) -> jax.Array:
    """Route an extra field through a recorded exchange (reapplySync,
    domain.hpp:335-378). Returns the post-exchange owned order; slots >=
    rec.n_owned are unspecified."""
    cap = prop.shape[0]
    recv = all_to_all(prop[rec.send_idx], axis_name).reshape(-1)
    merged = jnp.concatenate([prop, recv])[rec.merge_perm]
    return merged[:cap]


# ---------------------------------------------------------------------------
# range query services (exchange_focus.hpp:290-344 exchangeTreeletGeneral)
# ---------------------------------------------------------------------------


def _serve_ranges(
    req_a: jax.Array,  # (R, q_cap) range start keys received from each rank
    req_b: jax.Array,  # (R, q_cap) range end keys
    served_keys: jax.Array,  # (cap,) my sorted owned keys
    n_served,
) -> Tuple[jax.Array, jax.Array]:
    """Per-request [start, end) particle index ranges into served_keys."""
    shape = req_a.shape
    pa = _searchsorted(served_keys, req_a.reshape(-1), side="left")
    pb = _searchsorted(served_keys, req_b.reshape(-1), side="left")
    n = jnp.asarray(n_served, jnp.int32)
    pa = jnp.minimum(pa, n).reshape(shape)
    pb = jnp.minimum(pb, n).reshape(shape)
    return pa, pb


def _request_rows(
    dest: jax.Array,
    valid: jax.Array,
    q_cap: int,
    n_ranks: int,
    my_rank,
    window: Optional[int],
):
    """Shared request-buffer addressing for the range services.

    Returns (rows, row, col, ok, exchange, overflow): `rows` is the buffer
    row count (n_ranks dense / 2*window+1 windowed), `row`/`col` the
    scatter coordinates of each valid in-window query, `ok` its mask,
    `exchange` the collective over (rows, ...) buffers, and `overflow` the
    q_cap shortfall. Out-of-window queries are masked out (callers decide
    whether that requires a window growth — e.g. Domain tracks the needed
    window across all protocols).
    """
    R = n_ranks
    row_dense, col = pack_by_dest(dest, valid, R)
    per_dest = jax.ops.segment_sum(
        valid.astype(jnp.int32), jnp.where(valid, dest, R), num_segments=R + 1
    )
    overflow = jnp.where(
        jnp.max(per_dest[:R]) > q_cap, jnp.max(per_dest[:R]), 0
    ).astype(jnp.int32)
    if window is None:
        rows = R

        def exchange(buf, axis_name):
            return all_to_all(buf, axis_name)

        return rows, row_dense, col, valid & (col < q_cap), exchange, overflow
    W = int(window)
    rows = 2 * W + 1
    wrow, in_win = dest_to_window_row(dest, my_rank, W, R)
    ok = valid & in_win & (col < q_cap)

    def exchange(buf, axis_name):
        return windowed_exchange(buf, axis_name, W, R)

    return rows, wrow, col, ok, exchange, overflow


def range_count_service(
    query_a: jax.Array,  # (Q,) range start keys, sorted by dest
    query_b: jax.Array,  # (Q,) range end keys
    dest: jax.Array,  # (Q,) int32 owner rank per query, nondecreasing
    valid: jax.Array,  # (Q,) bool
    served_keys: jax.Array,  # (cap,) my sorted owned keys (serving side)
    n_served,
    n_ranks: int,
    q_cap: int,
    axis_name: Optional[str],
    my_rank=None,
    window: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact particle counts of key ranges owned by other ranks.

    The JAX analog of the focus tree's peer count exchange
    (octree_focus_mpi.hpp:205-273 updateCounts + exchange_focus.hpp
    exchangeTreeletGeneral): every rank asks each range's owner to count it
    against the owner's sorted particle keys — two exchange rounds. With
    `window` set, buffers are (2*window+1, q_cap) and the exchange rides
    ppermute rounds over the SFC-surface peer window (peers.hpp:63-117
    scoping); out-of-window queries return 0 and must be handled by the
    caller (Domain routes them to global-tree counts, rebalance.hpp:279-299).

    Returns (counts (Q,) int32 — zero for invalid queries, overflow int32).
    """
    dt = query_a.dtype
    rows, row, col, ok, exchange, overflow = _request_rows(
        dest, valid, q_cap, n_ranks, my_rank, window
    )

    rr = jnp.where(ok, row, rows)
    cc = jnp.where(ok, col, 0)
    buf_a = jnp.zeros((rows, q_cap), dt).at[rr, cc].set(query_a, mode="drop")
    buf_b = jnp.zeros((rows, q_cap), dt).at[rr, cc].set(query_b, mode="drop")

    req_a = exchange(buf_a, axis_name)
    req_b = exchange(buf_b, axis_name)
    pa, pb = _serve_ranges(req_a, req_b, served_keys, n_served)
    resp = exchange(pb - pa, axis_name)  # (rows, q_cap) counts back

    counts = jnp.where(ok, resp[jnp.minimum(row, rows - 1), cc], 0)
    return counts.astype(jnp.int32), overflow


def range_sum_service(
    query_a: jax.Array,
    query_b: jax.Array,
    dest: jax.Array,
    valid: jax.Array,
    served_keys: jax.Array,
    n_served,
    served_values: jax.Array,  # (cap, V) per-particle values to sum
    n_ranks: int,
    q_cap: int,
    axis_name: Optional[str],
    my_rank=None,
    window: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact per-range sums of particle values owned by other ranks — the
    quantity exchange used for LET mass centers (exchange_focus.hpp:290-344,
    octree_focus_mpi.hpp:369-449 updateCenters). `window` scopes buffers and
    traffic to the peer window as in range_count_service.

    Returns (sums (Q, V) — zero for invalid queries, overflow int32).
    """
    V = served_values.shape[1]
    dt = query_a.dtype
    rows, row, col, ok, exchange, overflow = _request_rows(
        dest, valid, q_cap, n_ranks, my_rank, window
    )

    rr = jnp.where(ok, row, rows)
    cc = jnp.where(ok, col, 0)
    buf_a = jnp.zeros((rows, q_cap), dt).at[rr, cc].set(query_a, mode="drop")
    buf_b = jnp.zeros((rows, q_cap), dt).at[rr, cc].set(query_b, mode="drop")

    req_a = exchange(buf_a, axis_name)
    req_b = exchange(buf_b, axis_name)
    pa, pb = _serve_ranges(req_a, req_b, served_keys, n_served)

    # prefix sums over served values -> range sums are two gathers
    cap = served_keys.shape[0]
    n = jnp.asarray(n_served, jnp.int32)
    slot = jnp.arange(cap, dtype=jnp.int32)
    vals = jnp.where((slot < n)[:, None], served_values, 0)
    scan = jnp.concatenate(
        [jnp.zeros((1, V), vals.dtype), jnp.cumsum(vals, axis=0)], axis=0
    )
    sums = scan[pb] - scan[pa]  # (rows, q_cap, V)
    resp = exchange(sums, axis_name)

    out = jnp.where(ok[:, None], resp[jnp.minimum(row, rows - 1), cc], 0)
    return out, overflow


# ---------------------------------------------------------------------------
# halo particle exchange (exchange_keys.hpp + exchange_halos.hpp analog)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HaloRecord:
    """Recorded halo exchange pattern: owner-side gathers and receiver-side
    scatters for one sync epoch. Every exchange_halo_field call replays it
    (the reference re-uses its SendList the same way, halos.hpp:232-251).
    Rows span the full rank axis (dense) or the 2*window+1 peer window;
    `window` is static and marks which exchange routes the replay."""

    send_idx: jax.Array  # (rows, halo_cap) int32 gather into owned-sorted arrays
    send_valid: jax.Array  # (rows, halo_cap) bool
    recv_idx: jax.Array  # (rows, halo_cap) int32 scatter into local layout buffers
    recv_valid: jax.Array  # (rows, halo_cap) bool
    overflow: jax.Array  # int32
    window: Optional[int] = field(default=None, metadata=dict(static=True))
    n_ranks: int = field(default=0, metadata=dict(static=True))


def build_halo_exchange(
    leaf_a: jax.Array,  # (cap_leaf,) leaf range start keys
    leaf_b: jax.Array,  # (cap_leaf,) leaf range end keys
    leaf_counts: jax.Array,  # (cap_leaf,) exact particle counts per leaf
    layout: jax.Array,  # (cap_leaf+1,) local buffer offsets per leaf
    halo_request: jax.Array,  # (cap_leaf,) bool: leaves to fetch
    owner: jax.Array,  # (cap_leaf,) int32 owner rank per leaf, nondecreasing
    served_keys: jax.Array,  # (cap,) my sorted owned keys
    n_served,
    n_ranks: int,
    req_cap: int,
    halo_cap: int,
    axis_name: Optional[str],
    my_rank=None,
    window: Optional[int] = None,
) -> HaloRecord:
    """One round of the request-keys protocol (exchange_keys.hpp:63-119):
    send requested key ranges to their owners; owners translate them to
    index ranges of their sorted particles. Returns the send/recv pattern
    for this epoch; particles themselves move in exchange_halo_field.
    With `window` set, the request and particle buffers span 2*window+1
    peer rows instead of the rank axis (halo owners are SFC-surface peers,
    peers.hpp:63-117); out-of-window requests are dropped and must be
    flagged by the caller as a window shortfall.
    """
    R = n_ranks
    dt = leaf_a.dtype
    cap_leaf = leaf_a.shape[0]

    rows, row, col, ok, exchange, overflow = _request_rows(
        owner, halo_request, req_cap, R, my_rank, window
    )

    rr = jnp.where(ok, row, rows)
    cc = jnp.where(ok, col, 0)
    buf_a = jnp.zeros((rows, req_cap), dt).at[rr, cc].set(leaf_a, mode="drop")
    buf_b = jnp.zeros((rows, req_cap), dt).at[rr, cc].set(leaf_b, mode="drop")

    req_a = exchange(buf_a, axis_name)
    req_b = exchange(buf_b, axis_name)
    pa, pb = _serve_ranges(req_a, req_b, served_keys, n_served)  # (rows, req_cap)

    # ---- owner side: pack requested ranges into (R, halo_cap) gathers ----
    send_idx, send_valid, send_ovf = _segment_fill(pa, pb - pa, halo_cap)

    # ---- receiver side: scatter targets from layout ----------------------
    # responses return on the same buffer row the request went out on, so
    # the scatter-target map uses the (rows, req_cap) protocol layout —
    # dense rows == n_ranks, windowed rows == 2*window+1
    starts = jnp.zeros((rows, req_cap), jnp.int32).at[rr, cc].set(
        layout[jnp.arange(cap_leaf, dtype=jnp.int32)], mode="drop"
    )
    lens = jnp.zeros((rows, req_cap), jnp.int32).at[rr, cc].set(
        leaf_counts.astype(jnp.int32), mode="drop"
    )
    recv_idx, recv_valid, recv_ovf = _segment_fill(starts, lens, halo_cap)

    overflow = jnp.maximum(overflow, jnp.maximum(send_ovf, recv_ovf))
    return HaloRecord(
        send_idx=send_idx,
        send_valid=send_valid,
        recv_idx=recv_idx,
        recv_valid=recv_valid,
        overflow=overflow,
        window=None if window is None else int(window),
        n_ranks=R,
    )


def _segment_fill(
    starts: jax.Array, lens: jax.Array, out_cap: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Flatten per-row [start, start+len) runs into (rows, out_cap) index
    streams (scatter + cummax segment fill, as in traversal/neighbors.py)."""
    rows, K = starts.shape
    lens = jnp.maximum(lens, 0)
    inc = jnp.cumsum(lens, axis=1)
    total = inc[:, -1]
    exc = inc - lens
    overflow = jnp.where(jnp.max(total) > out_cap, jnp.max(total), 0).astype(
        jnp.int32
    )

    k = jnp.arange(K, dtype=jnp.int32)
    row_ids = jnp.arange(rows, dtype=jnp.int32)[:, None]
    seg0 = jnp.zeros((rows, out_cap), jnp.int32)
    okk = (lens > 0) & (exc < out_cap)
    seg0 = seg0.at[
        jnp.where(okk, row_ids, rows), jnp.where(okk, exc, 0)
    ].max(jnp.broadcast_to(k[None, :], exc.shape), mode="drop")
    seg = jax.lax.cummax(seg0, axis=1)

    j = jnp.arange(out_cap, dtype=jnp.int32)
    idx = jnp.take_along_axis(starts, seg, axis=1) + (
        j[None, :] - jnp.take_along_axis(exc, seg, axis=1)
    )
    valid = j[None, :] < jnp.minimum(total, out_cap)[:, None]
    return jnp.where(valid, idx, 0), valid, overflow


def exchange_halo_field(
    owned_sorted: jax.Array,  # (cap,) field over post-exchange owned order
    local_buf: jax.Array,  # (cap,) field in layout order to fill halos into
    rec: HaloRecord,
    axis_name: Optional[str],
) -> jax.Array:
    """Move one field's halo values (exchange_halos.hpp:28-93): owner-side
    gather, one exchange round (all_to_all or peer-window ppermutes, per
    the record), receiver-side scatter into layout slots."""
    cap = owned_sorted.shape[0]
    safe_idx = jnp.clip(rec.send_idx, 0, cap - 1)
    send = jnp.where(rec.send_valid, owned_sorted[safe_idx], 0)
    if rec.window is None:
        recv = all_to_all(send, axis_name)
    else:
        recv = windowed_exchange(send, axis_name, rec.window, rec.n_ranks)
    tgt = jnp.where(rec.recv_valid, rec.recv_idx, local_buf.shape[0])
    return local_buf.at[tgt].set(recv, mode="drop")
