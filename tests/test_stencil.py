"""The 27-point cell-list stencil: the plain XLA stencil against the f64
O(n^2) oracle, the Pallas kernel (interpret mode) against the plain
stencil, the kernel's GPU lowering, and the choice between the two.

Same neighbor contract as test_neighbors.py (findneighbors.hpp:96-165:
j != i with d2 < (2 h_i)^2) and the SPH density formula of
models/sph.py; "cross" runs two disjoint particle sets on one grid, the
tiered path's cross-tier leg.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cstone_tpu.ops.pallas_stencil import stencil_pallas
from cstone_tpu.sfc import PERIODIC, compute_sfc_keys, make_box
from cstone_tpu.traversal.celllist import (
    choose_cell_level,
    choose_stencil,
    ell_pack_gather,
    rowmajor_cell_perm,
    stencil_xla,
)

OPS = ("count", "density", "density_mass", "cross")


def _w_cubic(q):
    w1 = 1.0 - 1.5 * q * q * (1.0 - 0.5 * q)
    w2 = 0.25 * (2.0 - q) ** 3
    return np.where(q < 1.0, w1, np.where(q < 2.0, w2, 0.0))


def _pack(pos, h, m, box, level, cap):
    """Key-sort and ELL-pack one particle set; returns (planes, pidx,
    order) with planes = (x, y, z, h, m) each (n_cells, cap)."""
    x, y, z = (jnp.asarray(pos[:, i]) for i in range(3))
    keys = np.asarray(compute_sfc_keys(x, y, z, box, jnp.uint64))
    order = np.argsort(keys, kind="stable")
    perm, _ = rowmajor_cell_perm(level)
    fields = tuple(jnp.asarray(a[order]) for a in
                   (pos[:, 0], pos[:, 1], pos[:, 2], h, m))
    planes, valid, pidx, ovf = ell_pack_gather(
        jnp.asarray(keys[order]), perm, fields, cap, level)
    assert not bool(ovf)
    planes = planes[:4] + (jnp.where(valid, planes[4], 0.0),)
    return planes, valid, pidx, order


def _unpack(vals_ell, pidx, order):
    """ELL slot values -> the particle set's input order."""
    _, v = jax.lax.sort((pidx.reshape(-1), vals_ell.reshape(-1)), num_keys=1)
    out = np.empty(order.shape[0], np.asarray(v).dtype)
    out[order] = np.asarray(v)[: order.shape[0]]
    return out


def _case(op, periodic, seed=11):
    """(stencil args builder, f64 expected, compare) for one op."""
    rng = np.random.RandomState(seed)
    n = 900
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.06, 0.12, size=n).astype(np.float32)
    m = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    box = make_box(-1.0, 1.0, boundaries=PERIODIC if periodic else 0)
    level = choose_cell_level(box, float(h.max()))
    cap = 24  # not a power of two: the kernel pads it
    tgt_sel = np.arange(n) if op != "cross" else np.arange(n // 2)
    cand_sel = np.arange(n) if op != "cross" else np.arange(n // 2, n)

    tp, tvalid, tpidx, torder = _pack(
        pos[tgt_sel], h[tgt_sel], m[tgt_sel], box, level, cap)
    if op == "cross":
        cp, _, _, _ = _pack(pos[cand_sel], h[cand_sel], m[cand_sel], box,
                            level, 32)
    else:
        cp = tp
    is_count = op in ("count", "cross")
    param = (jnp.where(tvalid, (2.0 * tp[3]) ** 2, -1.0) if is_count
             else tp[3])
    kwargs = dict(
        op="count" if is_count else "density",
        exclude_self=op != "cross",
        cand_mass=cp[4] if op == "density_mass" else None,
    )
    args = ((tp[0], tp[1], tp[2], param), cp[:3], box.lengths,
            (periodic,) * 3, level)

    X = pos.astype(np.float64)
    d = X[tgt_sel][:, None, :] - X[cand_sel][None, :, :]
    if periodic:
        d -= 2.0 * np.rint(d / 2.0)
    r = np.sqrt((d ** 2).sum(-1))
    if op != "cross":
        np.fill_diagonal(r, np.inf)
    ht = h[tgt_sel].astype(np.float64)[:, None]
    if is_count:
        expected = (r < 2.0 * ht).sum(1)
    else:
        w = _w_cubic(r / ht)
        if op == "density_mass":
            w = w * m[cand_sel].astype(np.float64)[None, :]
        expected = w.sum(1)

    def run(stencil):
        return _unpack(stencil(*args, **kwargs), tpidx, torder)

    return run, expected, is_count


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_plain_stencil_vs_bruteforce(op, periodic):
    run, expected, is_count = _case(op, periodic)
    got = run(stencil_xla)
    if is_count:
        np.testing.assert_array_equal(got, expected)
    else:
        np.testing.assert_allclose(got, expected, rtol=1e-5,
                                   atol=1e-6 * expected.max())


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_kernel_interpret_matches_plain(op, periodic):
    run, _, is_count = _case(op, periodic, seed=23)
    want = run(stencil_xla)
    got = run(partial(stencil_pallas, interpret=True))
    if is_count:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * want.max())


@pytest.mark.parametrize("op", ["count", "density_mass", "cross"])
def test_kernel_lowers_for_gpu(op):
    # the Triton lowering runs in Python, so a kernel that uses a
    # primitive the Triton route cannot lower fails here, without a card
    rng = np.random.RandomState(0)
    D, cap = 8, 64
    planes = [jnp.asarray(rng.rand(D ** 3, cap).astype(np.float32))
              for _ in range(5)]
    tgt, cand = tuple(planes[:4]), tuple(planes[:3])
    fn = jax.jit(partial(
        stencil_pallas, lengths=jnp.ones(3), periodic=(True, True, False),
        level=3, op="count" if op != "density_mass" else "density",
        exclude_self=op != "cross",
        cand_mass=planes[4] if op == "density_mass" else None))
    text = fn.trace(tgt, cand).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.parametrize("platform,want", [
    ("gpu", stencil_pallas), ("cpu", stencil_xla), ("rocm", stencil_xla)])
def test_choose_stencil_by_platform(platform, want):
    assert choose_stencil(platform) is want


def test_choose_stencil_default_is_plain_on_cpu():
    assert jax.default_backend() == "cpu"
    assert choose_stencil() is stencil_xla


def test_kernel_rejects_self_exclusion_across_packs():
    z = jnp.zeros((64, 8), jnp.float32)
    with pytest.raises(ValueError, match="one pack"):
        stencil_pallas((z, z, z, z), (z[:, :4],) * 3, jnp.ones(3),
                       (True,) * 3, 2, exclude_self=True)
