"""Ragged peer exchange: sparse protocols over jax.lax.ragged_all_to_all.

The dense protocols in parallel/exchange.py move (n_ranks, cap) buffers —
per-rank memory O(R * cap) with mostly-empty lanes when the peer set is
small. The reference bounds all P2P traffic by the discovered SFC-surface
peer set (peers.hpp:63-117, exchange_focus.hpp:62-96); the collective
equivalent of "send only to peers, sized exactly" is the ragged all-to-all
collective: one concatenated operand sorted by destination rank, per-rank
offset/size vectors, and buffers sized by the MEASURED surface total —
independent of the rank count.

Every protocol here is two phases:
  1. a size negotiation — (R,)-int32 dense all_to_all rounds (a few hundred
     bytes), establishing clamped sizes and remote write offsets;
  2. the payload — ONE ragged_all_to_all per field.

Totals exceeding the static capacity are clamped consistently on both
sides and reported as overflow, feeding the same host retry-growth loops
as every other capacity (util/reallocate.hpp semantics).

Everything must run inside shard_map with `axis_name` bound; axis_name
None degrades to the single-rank identity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.primitives import searchsorted as _searchsorted

__all__ = [
    "RaggedMeta",
    "ragged_meta",
    "ragged_send",
    "ragged_return",
    "compact_by_dest",
    "range_count_service_ragged",
    "range_sum_service_ragged",
    "RaggedHaloRecord",
    "build_halo_exchange_ragged",
    "exchange_halo_field_ragged",
]


def _excl_cumsum(x: jax.Array) -> jax.Array:
    x = x.astype(jnp.int32)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(x)[:-1]])


def _a2a(x: jax.Array, axis_name: Optional[str]) -> jax.Array:
    if axis_name is None:
        return x
    return jax.lax.all_to_all(x, axis_name, split_axis=0, concat_axis=0, tiled=True)


def use_native_ragged() -> bool:
    """Whether the ragged protocols run the native ragged_all_to_all.

    Only with CSTONE_RAGGED=native. XLA:CPU does not implement the HLO
    (the virtual test mesh and the multichip dry run). XLA's GPU backend
    lowers it, and it matches the emulation in
    tests/test_exchange_ragged.py on four GPUs, but Domain.sync has not
    yet run it at scale, so every platform takes the dense-padded
    emulation below by default, which has identical semantics."""
    import os

    return os.environ.get("CSTONE_RAGGED", "") == "native"


def _ragged_a2a(
    operand: jax.Array,
    output: jax.Array,
    input_offsets: jax.Array,
    send_sizes: jax.Array,
    output_offsets: jax.Array,
    recv_sizes: jax.Array,
    axis_name: str,
) -> jax.Array:
    """jax.lax.ragged_all_to_all, or its dense-padded emulation on CPU.

    The emulation reproduces the op bit-for-bit: chunk r of the operand
    ([input_offsets[r], +send_sizes[r])) is padded into lane r of a dense
    (R, out_cap) buffer, one all_to_all moves it, and each received chunk
    lands at the offset its SENDER specified (output_offsets travels with
    the data, exactly the native op's contract)."""
    if use_native_ragged():
        # the collective needs all four offset/size vectors of one type
        return jax.lax.ragged_all_to_all(
            operand, output,
            *(a.astype(jnp.int32) for a in (
                input_offsets, send_sizes, output_offsets, recv_sizes)),
            axis_name=axis_name,
        )
    out_cap = output.shape[0]
    R = send_sizes.shape[0]
    j = jnp.arange(out_cap, dtype=jnp.int32)
    src = jnp.minimum(
        input_offsets[:, None] + j[None, :], operand.shape[0] - 1
    )
    lanes = operand[src]  # (R, out_cap, ...)
    lane_valid = j[None, :] < send_sizes[:, None]
    recv = _a2a(lanes, axis_name)
    recv_valid = _a2a(lane_valid, axis_name)
    my_write_off = _a2a(output_offsets, axis_name)  # senders' declared offsets
    tgt = my_write_off[:, None] + j[None, :]
    tgt = jnp.where(recv_valid, tgt, out_cap)
    return output.at[tgt.reshape(-1)].set(
        recv.reshape((-1,) + recv.shape[2:]), mode="drop"
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RaggedMeta:
    """Negotiated size/offset vectors for one request->response round trip.

    All (R,) int32. `input_offsets`/`send_sizes` slice my operand per
    destination; `output_offsets` are my chunks' write offsets in each
    receiver's buffer; `recv_sizes`/`recv_offsets` lay out what I receive.
    `ret_output_offsets` routes the RESPONSE leg: where my response chunks
    land in each requester's original operand-aligned buffer. Sizes are
    pre-clamped so no write exceeds the receiver's capacity; `overflow`
    carries the unclamped total when it did not fit.
    """

    input_offsets: jax.Array
    send_sizes: jax.Array  # clamped to what the receiver can accept
    output_offsets: jax.Array
    recv_sizes: jax.Array
    recv_offsets: jax.Array
    ret_output_offsets: jax.Array
    overflow: jax.Array  # int32: required capacity when out_cap was short


def ragged_meta(
    send_sizes: jax.Array,  # (R,) int32 items for each rank, my operand sorted by dest
    out_cap: int,
    axis_name: Optional[str],
) -> RaggedMeta:
    """Negotiate one ragged round: 2 dense (R,k)-int32 all_to_all rounds."""
    send_sizes = send_sizes.astype(jnp.int32)
    input_offsets = _excl_cumsum(send_sizes)

    recv_raw = _a2a(send_sizes, axis_name)  # (R,)
    inc = jnp.cumsum(recv_raw)
    total = inc[-1]
    off_raw = inc - recv_raw
    recv_offsets = jnp.minimum(off_raw, out_cap)
    recv_sizes = jnp.minimum(inc, out_cap) - recv_offsets
    overflow = jnp.where(total > out_cap, total, 0).astype(jnp.int32)

    # one (R,3) round returns: clamped send sizes, my remote write offsets,
    # and the response leg's remote write offsets
    back = _a2a(
        jnp.stack([recv_sizes, recv_offsets, input_offsets], axis=-1), axis_name
    )
    return RaggedMeta(
        input_offsets=input_offsets,
        send_sizes=back[:, 0],
        output_offsets=back[:, 1],
        recv_sizes=recv_sizes,
        recv_offsets=recv_offsets,
        ret_output_offsets=back[:, 2],
        overflow=overflow,
    )


def _identity_copy(operand: jax.Array, out_cap: int, n: jax.Array, fill) -> jax.Array:
    """Single-rank degenerate: first n rows of operand land at offset 0."""
    j = jnp.arange(out_cap, dtype=jnp.int32)
    src = jnp.minimum(j, operand.shape[0] - 1)
    out = operand[src]
    mask = j < n
    if out.ndim > 1:
        mask = mask.reshape((-1,) + (1,) * (out.ndim - 1))
    return jnp.where(mask, out, fill)


def ragged_send(
    operand: jax.Array,  # (N, ...) concatenated by destination rank
    out_cap: int,
    meta: RaggedMeta,
    axis_name: Optional[str],
    fill=0,
) -> jax.Array:
    """Request leg: my dest-sorted operand chunks scatter into each
    receiver's (out_cap, ...) buffer grouped by source rank."""
    if axis_name is None:
        return _identity_copy(operand, out_cap, meta.recv_sizes[0], fill)
    output = jnp.full((out_cap,) + operand.shape[1:], fill, operand.dtype)
    return _ragged_a2a(
        operand, output, meta.input_offsets, meta.send_sizes,
        meta.output_offsets, meta.recv_sizes, axis_name,
    )


def ragged_return(
    responses: jax.Array,  # (out_cap, ...) aligned with the request recv buffer
    q_len: int,  # my operand length on the request leg
    meta: RaggedMeta,
    axis_name: Optional[str],
    fill=0,
) -> jax.Array:
    """Response leg: roles swap. Each server's response chunks (laid out
    exactly like its request recv buffer) travel back and land at the
    requester's original input offsets — so the result aligns 1:1 with the
    dest-sorted request operand."""
    if axis_name is None:
        return _identity_copy(responses, q_len, meta.send_sizes[0], fill)
    output = jnp.full((q_len,) + responses.shape[1:], fill, responses.dtype)
    return _ragged_a2a(
        responses, output, meta.recv_offsets, meta.recv_sizes,
        meta.ret_output_offsets, meta.send_sizes, axis_name,
    )


def compact_by_dest(
    dest: jax.Array,  # (Q,) int32 destination rank, NONDECREASING over valid items
    valid: jax.Array,  # (Q,) bool
    n_ranks: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(perm, send_sizes, n_valid): one stable sort moves invalid items to
    the back while keeping the valid items' dest grouping; perm gathers the
    compacted order from the original, send_sizes[r] counts valid items
    for rank r."""
    Q = dest.shape[0]
    key = jnp.where(valid, dest.astype(jnp.int32), n_ranks)
    iota = jnp.arange(Q, dtype=jnp.int32)
    _, perm = jax.lax.sort((key, iota), num_keys=1, is_stable=True)
    sizes = jax.ops.segment_sum(
        valid.astype(jnp.int32),
        jnp.where(valid, dest.astype(jnp.int32), n_ranks),
        num_segments=n_ranks + 1,
    )[:n_ranks]
    return perm, sizes, jnp.sum(sizes)


def _serve_ranges_flat(req_a, req_b, served_keys, n_served):
    pa = _searchsorted(served_keys, req_a, side="left")
    pb = _searchsorted(served_keys, req_b, side="left")
    n = jnp.asarray(n_served, jnp.int32)
    return jnp.minimum(pa, n).astype(jnp.int32), jnp.minimum(pb, n).astype(jnp.int32)


def range_count_service_ragged(
    query_a: jax.Array,  # (Q,) range start keys, sorted by dest over valid items
    query_b: jax.Array,
    dest: jax.Array,
    valid: jax.Array,
    served_keys: jax.Array,
    n_served,
    n_ranks: int,
    q_total_cap: int,  # TOTAL foreign queries served per rank — O(surface)
    axis_name: Optional[str],
) -> Tuple[jax.Array, jax.Array]:
    """Exact foreign range counts (updateCounts / exchangeTreeletGeneral
    analog, octree_focus_mpi.hpp:205-273) with O(surface) buffers: the
    ragged counterpart of exchange.range_count_service."""
    Q = query_a.shape[0]
    perm, sizes, _ = compact_by_dest(dest, valid, n_ranks)
    qa = query_a[perm]
    qb = query_b[perm]
    meta = ragged_meta(sizes, q_total_cap, axis_name)

    req_a = ragged_send(qa, q_total_cap, meta, axis_name, fill=qa.dtype.type(0))
    req_b = ragged_send(qb, q_total_cap, meta, axis_name, fill=qb.dtype.type(0))
    pa, pb = _serve_ranges_flat(req_a, req_b, served_keys, n_served)
    back = ragged_return(pb - pa, Q, meta, axis_name)  # compacted order

    counts = jnp.zeros((Q,), jnp.int32).at[perm].set(back)
    return jnp.where(valid, counts, 0), meta.overflow


def range_sum_service_ragged(
    query_a: jax.Array,
    query_b: jax.Array,
    dest: jax.Array,
    valid: jax.Array,
    served_keys: jax.Array,
    n_served,
    served_values: jax.Array,  # (cap, V)
    n_ranks: int,
    q_total_cap: int,
    axis_name: Optional[str],
) -> Tuple[jax.Array, jax.Array]:
    """Exact foreign range value sums (updateCenters quantity exchange,
    exchange_focus.hpp:290-344) over ragged buffers."""
    Q = query_a.shape[0]
    V = served_values.shape[1]
    perm, sizes, _ = compact_by_dest(dest, valid, n_ranks)
    qa = query_a[perm]
    qb = query_b[perm]
    meta = ragged_meta(sizes, q_total_cap, axis_name)

    req_a = ragged_send(qa, q_total_cap, meta, axis_name, fill=qa.dtype.type(0))
    req_b = ragged_send(qb, q_total_cap, meta, axis_name, fill=qb.dtype.type(0))
    pa, pb = _serve_ranges_flat(req_a, req_b, served_keys, n_served)

    cap = served_keys.shape[0]
    n = jnp.asarray(n_served, jnp.int32)
    slot = jnp.arange(cap, dtype=jnp.int32)
    vals = jnp.where((slot < n)[:, None], served_values, 0)
    scan = jnp.concatenate(
        [jnp.zeros((1, V), vals.dtype), jnp.cumsum(vals, axis=0)], axis=0
    )
    resp = scan[pb] - scan[pa]  # (q_total_cap, V)
    back = ragged_return(resp, Q, meta, axis_name)

    out = jnp.zeros((Q, V), back.dtype).at[perm].set(back)
    return jnp.where(valid[:, None], out, 0), meta.overflow


# ---------------------------------------------------------------------------
# halo exchange (exchange_keys.hpp + exchange_halos.hpp over ragged buffers)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RaggedHaloRecord:
    """Recorded ragged halo pattern for one sync epoch: owner-side flat
    gather stream, receiver-side flat scatter stream, and the negotiated
    particle-leg meta. Each exchange_halo_field_ragged call replays it with
    ONE ragged_all_to_all (halos.hpp:232-251 SendList reuse semantics) —
    total buffer length O(surface), independent of the rank count."""

    gather_idx: jax.Array  # (halo_total_cap,) int32 into owned-sorted arrays
    gather_valid: jax.Array  # (halo_total_cap,) bool
    scatter_idx: jax.Array  # (halo_total_cap,) int32 into local layout buffers
    scatter_valid: jax.Array  # (halo_total_cap,) bool
    meta: RaggedMeta
    overflow: jax.Array
    halo_total_cap: int = field(default=0, metadata=dict(static=True))


def _flat_segment_fill(starts, lens, out_cap):
    """Flatten [start, start+len) runs (in order) into one (out_cap,) index
    stream; returns (idx, valid, overflow)."""
    K = starts.shape[0]
    lens = jnp.maximum(lens.astype(jnp.int32), 0)
    inc = jnp.cumsum(lens)
    total = inc[-1]
    exc = inc - lens
    overflow = jnp.where(total > out_cap, total, 0).astype(jnp.int32)

    k = jnp.arange(K, dtype=jnp.int32)
    okk = (lens > 0) & (exc < out_cap)
    seg0 = jnp.zeros((out_cap,), jnp.int32).at[jnp.where(okk, exc, out_cap)].max(
        k, mode="drop"
    )
    seg = jax.lax.cummax(seg0)
    j = jnp.arange(out_cap, dtype=jnp.int32)
    idx = starts[seg] + (j - exc[seg])
    valid = j < jnp.minimum(total, out_cap)
    return jnp.where(valid, idx, 0), valid, overflow


def build_halo_exchange_ragged(
    leaf_a: jax.Array,  # (cap_leaf,) leaf range start keys
    leaf_b: jax.Array,
    leaf_counts: jax.Array,  # (cap_leaf,) exact counts per leaf
    layout: jax.Array,  # (cap_leaf+1,) local buffer offsets per leaf
    halo_request: jax.Array,  # (cap_leaf,) bool
    owner: jax.Array,  # (cap_leaf,) int32, nondecreasing
    served_keys: jax.Array,
    n_served,
    n_ranks: int,
    req_total_cap: int,  # total halo CELL requests served — O(surface cells)
    halo_total_cap: int,  # total halo PARTICLES moved — O(surface particles)
    axis_name: Optional[str],
) -> RaggedHaloRecord:
    """Request-keys protocol (exchange_keys.hpp:63-119) over ragged
    buffers. Owners translate requested key ranges to particle index
    ranges; both sides flatten their runs into one gather/scatter stream.
    Arrival order is deterministic: concatenation by source rank in rank
    order — which is exactly the receiver's owner-sorted request order, so
    the receiver's scatter stream is its own layout runs flattened."""
    cap_leaf = leaf_a.shape[0]
    perm, sizes, _ = compact_by_dest(owner, halo_request, n_ranks)
    qa = leaf_a[perm]
    qb = leaf_b[perm]
    meta_req = ragged_meta(sizes, req_total_cap, axis_name)

    req_a = ragged_send(qa, req_total_cap, meta_req, axis_name, fill=qa.dtype.type(0))
    req_b = ragged_send(qb, req_total_cap, meta_req, axis_name, fill=qb.dtype.type(0))
    pa, pb = _serve_ranges_flat(req_a, req_b, served_keys, n_served)
    # zero out slots beyond the requests actually received
    jq = jnp.arange(req_total_cap, dtype=jnp.int32)
    n_req = jnp.sum(meta_req.recv_sizes)
    run_len = jnp.where(jq < n_req, pb - pa, 0)

    # ---- owner side: flatten served runs into the particle send stream --
    gather_idx, gather_valid, send_ovf = _flat_segment_fill(
        pa, run_len, halo_total_cap
    )
    # particles per CLIENT rank: segment-sum run lengths by source-rank
    # chunk of the request recv buffer
    src_rank = (
        _searchsorted(meta_req.recv_offsets, jq, side="right").astype(jnp.int32) - 1
    )
    src_rank = jnp.clip(src_rank, 0, n_ranks - 1)
    part_sizes = jax.ops.segment_sum(run_len, src_rank, num_segments=n_ranks)
    meta_halo = ragged_meta(part_sizes, halo_total_cap, axis_name)

    # ---- receiver side: my layout runs flattened in compacted order -----
    req_sorted = halo_request[perm]
    starts = jnp.where(req_sorted, layout[perm], 0)
    lens = jnp.where(req_sorted, leaf_counts[perm].astype(jnp.int32), 0)
    scatter_idx, scatter_valid, recv_ovf = _flat_segment_fill(
        starts, lens, halo_total_cap
    )

    overflow = jnp.maximum(
        meta_req.overflow, jnp.maximum(meta_halo.overflow,
                                       jnp.maximum(send_ovf, recv_ovf))
    )
    return RaggedHaloRecord(
        gather_idx=gather_idx,
        gather_valid=gather_valid,
        scatter_idx=scatter_idx,
        scatter_valid=scatter_valid,
        meta=meta_halo,
        overflow=overflow,
        halo_total_cap=int(halo_total_cap),
    )


def exchange_halo_field_ragged(
    owned_sorted: jax.Array,  # (cap,) field over post-exchange owned order
    local_buf: jax.Array,  # (cap,) field in layout order
    rec: RaggedHaloRecord,
    axis_name: Optional[str],
) -> jax.Array:
    """One field's halo move (exchange_halos.hpp:28-93): flat gather, ONE
    ragged exchange, flat scatter into layout slots."""
    cap = owned_sorted.shape[0]
    safe = jnp.clip(rec.gather_idx, 0, cap - 1)
    send = jnp.where(rec.gather_valid, owned_sorted[safe], 0)
    recv = ragged_send(send, rec.halo_total_cap, rec.meta, axis_name)
    tgt = jnp.where(rec.scatter_valid, rec.scatter_idx, local_buf.shape[0])
    return local_buf.at[tgt].set(recv, mode="drop")
