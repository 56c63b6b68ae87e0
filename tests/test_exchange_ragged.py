"""Ragged protocol tests (parallel/ragged.py): the surface-proportional
realization of the reference's peer-bounded P2P traffic (peers.hpp:63-117,
exchange_focus.hpp:62-96) over jax.lax.ragged_all_to_all.

Covers: service equivalence against the dense all_to_all protocols,
overflow negotiation (clamped consistently, required size reported), the
Domain halo path end to end, and the flagship neighbor-sum invariant with
protocol="ragged" — with TOTAL buffer capacities far below what the dense
(R, cap) layout would need, proving memory scales with the measured
surface rather than the rank count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from cstone_tpu.domain.domain import Domain
from cstone_tpu.parallel import make_mesh, rank_axis
from cstone_tpu.parallel.exchange import range_count_service, range_sum_service
from cstone_tpu.parallel.ragged import (
    range_count_service_ragged,
    range_sum_service_ragged,
)
from cstone_tpu.sfc import PERIODIC, make_box
from cstone_tpu.sfc.keys import remove_key

from test_domain import brute_force_total, _find_counts

R = 8


def _service_setup(seed=11, frac_valid=0.8):
    n, cap = 2400, 600
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.randint(0, 2**62, size=n).astype(np.uint64))
    vals = rng.uniform(0.1, 1.0, size=(n, 2)).astype(np.float32)
    rk = np.uint64(np.asarray(remove_key(np.dtype(np.uint64))))

    n_per = n // R
    lk = np.full((R, cap), rk, np.uint64)
    lv = np.zeros((R, cap, 2), np.float32)
    bounds = np.zeros(R + 1, np.uint64)
    for r in range(R):
        lk[r, :n_per] = keys[r * n_per : (r + 1) * n_per]
        lv[r, :n_per] = vals[r * n_per : (r + 1) * n_per]
        bounds[r] = keys[r * n_per]
    bounds[0] = np.uint64(0)
    bounds[R] = np.uint64(1) << np.uint64(63)

    Q = 64
    qa = np.zeros((R, Q), np.uint64)
    qb = np.zeros((R, Q), np.uint64)
    dest = np.zeros((R, Q), np.int32)
    valid = np.zeros((R, Q), bool)
    for r in range(R):
        a = rng.randint(0, 2**62, size=Q).astype(np.uint64)
        b = a + rng.randint(1, 2**55, size=Q).astype(np.uint64)
        d = np.searchsorted(bounds, a, side="right") - 1
        b = np.minimum(b, bounds[d + 1])
        order = np.argsort(d, kind="stable")
        qa[r], qb[r], dest[r] = a[order], b[order], d[order]
        valid[r] = rng.uniform(size=Q) < frac_valid
    return keys, vals, n_per, lk, lv, qa, qb, dest, valid


def _run_services(q_total_cap, setup):
    keys, vals, n_per, lk, lv, qa, qb, dest, valid = setup
    mesh = make_mesh(R)
    sh = NamedSharding(mesh, P(rank_axis))
    args = [
        jax.device_put(jnp.asarray(lk.reshape(-1)), sh),
        jax.device_put(jnp.asarray(lv.reshape(-1, 2)), sh),
        jax.device_put(jnp.asarray(qa.reshape(-1)), sh),
        jax.device_put(jnp.asarray(qb.reshape(-1)), sh),
        jax.device_put(jnp.asarray(dest.reshape(-1)), sh),
        jax.device_put(jnp.asarray(valid.reshape(-1)), sh),
    ]

    def step(lk, lv, qa, qb, d, v):
        cr, o1 = range_count_service_ragged(
            qa, qb, d, v, lk, jnp.int32(n_per), R, q_total_cap, rank_axis
        )
        sr, o2 = range_sum_service_ragged(
            qa, qb, d, v, lk, jnp.int32(n_per), lv, R, q_total_cap, rank_axis
        )
        cd, _ = range_count_service(
            qa, qb, d, v, lk, jnp.int32(n_per), R, 64, rank_axis
        )
        sd, _ = range_sum_service(
            qa, qb, d, v, lk, jnp.int32(n_per), lv, R, 64, rank_axis
        )
        ovf = jax.lax.pmax(jnp.maximum(o1, o2), rank_axis)
        return cr, sr, cd, sd, ovf

    fn = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(P(rank_axis),) * 6,
        out_specs=(P(rank_axis),) * 4 + (P(),), check_vma=False,
    ))
    cr, sr, cd, sd, ovf = jax.block_until_ready(fn(*args))
    return (np.asarray(cr), np.asarray(sr), np.asarray(cd), np.asarray(sd),
            int(ovf))


def test_ragged_services_match_dense_and_oracle():
    setup = _service_setup()
    keys, vals, n_per, lk, lv, qa, qb, dest, valid = setup
    cr, sr, cd, sd, ovf = _run_services(512, setup)
    assert ovf == 0
    np.testing.assert_array_equal(cr, cd)
    np.testing.assert_allclose(sr, sd, rtol=1e-6)
    cr = cr.reshape(R, -1)
    sr = sr.reshape(R, -1, 2)
    for r in range(R):
        for q in range(qa.shape[1]):
            if not valid[r, q]:
                assert cr[r, q] == 0
                continue
            sel = (keys >= qa[r, q]) & (keys < qb[r, q])
            assert cr[r, q] == int(sel.sum()), (r, q)
            # range sums are f32 prefix-scan differences: relative error
            # scales with prefix magnitude over range magnitude
            np.testing.assert_allclose(
                sr[r, q], vals[sel].sum(0), rtol=2e-4, atol=1e-4
            )


def test_ragged_service_overflow_reports_required_total():
    setup = _service_setup(seed=13, frac_valid=1.0)
    # 64 queries/rank spread over 7 foreign ranks: a total cap of 8 cannot
    # hold them; the reported requirement must make the retry succeed
    cr, sr, cd, sd, ovf = _run_services(8, setup)
    assert ovf > 8
    cr2, sr2, cd2, sd2, ovf2 = _run_services(int(ovf), setup)
    assert ovf2 == 0
    np.testing.assert_array_equal(cr2, cd2)


def test_domain_ragged_flagship_and_halo_fill():
    """Flagship neighbor-sum invariant + halo field fill on the ragged
    protocol, with TOTAL capacities (256 cells / 1200 particles) that the
    dense layout could not express below (R, cap/2) = 8x500 slots —
    protocol memory here scales with the measured halo surface."""
    n_ranks, n_per = 8, 250
    n = n_ranks * n_per
    cap = 4 * n_per
    rng = np.random.RandomState(17)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.03, 0.07, size=n).astype(np.float32)
    box = make_box(-1.0, 1.0, boundaries=PERIODIC)

    mesh = make_mesh(n_ranks)
    sharding = NamedSharding(mesh, P(rank_axis))

    def pad_local(a):
        out = np.zeros((n_ranks, cap), dtype=a.dtype)
        out[:, :n_per] = a.reshape(n_ranks, n_per)
        return jax.device_put(jnp.asarray(out.reshape(-1)), sharding)

    xl, yl, zl = pad_local(pos[:, 0]), pad_local(pos[:, 1]), pad_local(pos[:, 2])
    hl = pad_local(h)
    shapes = {}

    def step(xl, yl, zl, hl):
        rank = jax.lax.axis_index(rank_axis)
        domain = Domain(
            rank=rank, n_ranks=n_ranks, bucket_size=16, bucket_size_focus=8,
            key_dtype=jnp.uint64, tree_capacity=1024, focus_capacity=2048,
            axis_name=rank_axis, protocol="ragged",
            treelet_cap=2048, halo_req_cap=1024, halo_cap=2048,
        )
        state = domain.init_state(box=box, boundaries=box.boundaries)
        state, res = domain.sync(state, xl, yl, zl, hl, n_local=jnp.int32(n_per))
        shapes["gather"] = res.halo_record.gather_idx.shape
        counts, novf, _ = _find_counts(res, state.box, cap)
        j = jnp.arange(cap, dtype=jnp.int32)
        owned = (j >= res.start_index) & (j < res.end_index)

        # halo fill round-trip on the ragged record
        g = 3.0 * res.x + 7.0 * res.y + 11.0 * res.z
        prop = jnp.where(owned, g, 0.0)
        filled = domain.exchange_halos(res, prop)
        in_buf = j < res.n_with_halos
        halo_err = jnp.max(jnp.where(in_buf, jnp.abs(filled - g), 0.0))
        n_halo = jnp.sum((in_buf & (~owned)).astype(jnp.int32))

        return (
            jax.lax.psum(jnp.sum(jnp.where(owned, counts.astype(jnp.int64), 0)),
                         rank_axis),
            jax.lax.psum((res.end_index - res.start_index).astype(jnp.int64),
                         rank_axis),
            jax.lax.pmax(res.overflow + novf.astype(jnp.int32), rank_axis),
            jax.lax.pmax(halo_err, rank_axis),
            jax.lax.psum(n_halo, rank_axis),
        )

    fn = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(P(rank_axis),) * 4,
        out_specs=(P(),) * 5, check_vma=False,
    ))
    total, assigned, ovf, halo_err, n_halo = jax.block_until_ready(
        fn(xl, yl, zl, hl)
    )
    # ONE flat buffer sized by the halo total — not (R, cap) lanes
    assert shapes["gather"] == (2048,)
    assert int(ovf) == 0
    assert int(assigned) == n
    assert int(n_halo) > 0
    assert float(halo_err) < 1e-5
    expect = brute_force_total(pos, h, np.asarray(box.limits), True)
    assert int(total) == expect


def test_ragged_a2a_emulation_contract(monkeypatch):
    """Pin the CPU emulation to the documented jax.lax.ragged_all_to_all
    contract (r3 task 7b): sender r's chunk for destination j is
    operand[input_offsets[j] : +send_sizes[j]]; it lands in receiver j's
    output at the offset the SENDER specified (output_offsets[j]); slots
    not written keep the output's prior contents. Expected buffers are
    hand-computed from that contract, NOT from the emulation itself."""
    from cstone_tpu.parallel import ragged as rg

    monkeypatch.setenv("CSTONE_RAGGED", "emulate")
    out_cap = 24
    s = np.array([[(r + j) % 3 for j in range(R)] for r in range(R)],
                 np.int32)  # s[r][j] = size of chunk r -> j
    in_off = np.zeros((R, R), np.int32)
    for r in range(R):
        in_off[r] = np.concatenate([[0], np.cumsum(s[r])[:-1]])
    # receiver-side layout: chunk r -> j starts after all r' < r chunks
    out_off = np.zeros((R, R), np.int32)  # out_off[r][j]: r's offset at j
    for r in range(R):
        for j in range(R):
            out_off[r, j] = s[:r, j].sum()
    recv_sz = s.T.copy()  # recv_sizes[j][r] = s[r][j]
    op_len = int(s.sum(1).max())
    operand = np.zeros((R, op_len), np.float32)
    for r in range(R):
        k = 0
        for j in range(R):
            for t in range(s[r, j]):
                operand[r, k] = r * 1000 + j * 100 + t
                k += 1
    expected = np.full((R, out_cap), -1.0, np.float32)
    for j in range(R):
        for r in range(R):
            for t in range(s[r, j]):
                expected[j, out_off[r, j] + t] = r * 1000 + j * 100 + t

    mesh = make_mesh(R)
    sh = NamedSharding(mesh, P(rank_axis))

    def step(op, io, ss, oo, rs):
        out = jnp.full((out_cap,), -1.0, jnp.float32)
        return rg._ragged_a2a(op[0], out, io[0], ss[0], oo[0], rs[0],
                              rank_axis)[None]

    fn = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(P(rank_axis),) * 5,
        out_specs=P(rank_axis), check_vma=False,
    ))
    got = fn(
        jax.device_put(jnp.asarray(operand)[:, None], sh).reshape(R, op_len),
        jax.device_put(jnp.asarray(in_off[:, None, :]), sh).reshape(R, R),
        jax.device_put(jnp.asarray(s[:, None, :]), sh).reshape(R, R),
        jax.device_put(jnp.asarray(out_off[:, None, :]), sh).reshape(R, R),
        jax.device_put(jnp.asarray(recv_sz[:, None, :]), sh).reshape(R, R),
    )
    np.testing.assert_array_equal(np.asarray(got), expected)


@pytest.mark.gpu
def test_ragged_a2a_native_matches_emulation_on_gpu():
    """Native-vs-emulation parity: whenever >=2 GPUs exist, run the SAME
    inputs through CSTONE_RAGGED=native and =emulate and require
    bit-identical outputs. Skips (with reason) where there are fewer —
    the CPU lacks the native op, so only a multi-GPU host exercises the
    production protocol's collective."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if len(gpus) < 2:
        pytest.skip(
            f"needs >=2 GPUs for the native ragged_all_to_all (have "
            f"{len(gpus)}; CPU lacks the op)"
        )
    from cstone_tpu.parallel import ragged as rg
    import os

    Rt = 2 ** int(np.log2(len(gpus)))
    mesh = jax.sharding.Mesh(np.array(gpus[:Rt]), (rank_axis,))
    rng = np.random.RandomState(3)
    out_cap, op_len = 64, 64
    s = rng.randint(0, 6, size=(Rt, Rt)).astype(np.int32)
    in_off = np.concatenate(
        [np.zeros((Rt, 1), np.int32), np.cumsum(s, 1)[:, :-1]], 1
    ).astype(np.int32)
    out_off = np.cumsum(
        np.vstack([np.zeros((1, Rt), np.int32), s[:-1]]), 0).astype(np.int32)
    recv_sz = s.T.copy()
    operand = rng.uniform(0, 1, size=(Rt, op_len)).astype(np.float32)
    sh = NamedSharding(mesh, P(rank_axis))

    args = [jax.device_put(jnp.asarray(a), sh)
            for a in (operand, in_off, s, out_off, recv_sz)]
    outs = {}
    for mode in ("native", "emulate"):
        # a FRESH jit per mode: use_native_ragged() is read at trace
        # time, so reusing one jitted callable would replay the first
        # mode's jaxpr for both
        def step(op, io, ss, oo, rs):
            out = jnp.full((out_cap,), -1.0, jnp.float32)
            return rg._ragged_a2a(op[0], out, io[0], ss[0], oo[0], rs[0],
                                  rank_axis)[None]

        fn = jax.jit(shard_map(
            step, mesh=mesh, in_specs=(P(rank_axis),) * 5,
            out_specs=P(rank_axis), check_vma=False,
        ))
        os.environ["CSTONE_RAGGED"] = mode
        try:
            outs[mode] = np.asarray(fn(*args))
        finally:
            os.environ.pop("CSTONE_RAGGED", None)
    np.testing.assert_array_equal(outs["native"], outs["emulate"])
