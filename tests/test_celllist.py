"""Cell-list (ELL + 27-point roll stencil) neighbor counts vs the O(n^2)
oracle — same semantics contract as test_neighbors.py (reference:
test/unit/neighbors/all_to_all.hpp)."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest

from cstone_tpu.ops.pallas_stencil import stencil_pallas
from cstone_tpu.sfc import make_box, PERIODIC
from cstone_tpu.sfc.keys import max_tree_level
from cstone_tpu.traversal.celllist import (
    cell_list_neighbor_counts,
    choose_cell_level,
    stencil_xla,
)

KERNEL = partial(stencil_pallas, interpret=True)
from tests.test_neighbors import _setup, brute_force_counts


def _tight_cap(keys, level):
    k = np.asarray(keys)
    shift = 3 * (max_tree_level(k.dtype) - level)
    occ = np.bincount((k >> shift).astype(np.int64))
    return int(-(-int(occ.max()) // 8) * 8)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
def test_celllist_counts_vs_bruteforce(periodic, gauss):
    n = 2000
    x, y, z, h, keys, box = _setup(n, periodic, gauss=gauss)

    level = choose_cell_level(box, float(h.max()))
    counts, overflow = cell_list_neighbor_counts(
        keys, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(h),
        box, level, cap=_tight_cap(keys, level),
    )
    assert not bool(overflow)

    expected, _, _ = brute_force_counts(x, y, z, h, (-1, 1, -1, 1, -1, 1), periodic)
    np.testing.assert_array_equal(np.asarray(counts), expected)


def test_celllist_overflow_flag():
    x, y, z, h, keys, box = _setup(500, periodic=False)
    level = choose_cell_level(box, float(h.max()))
    _, overflow = cell_list_neighbor_counts(
        keys, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(h),
        box, level, cap=2,
    )
    assert bool(overflow)


def test_celllist_uniform_h_finer_level():
    # uniform small h -> deeper grid; counts must still be exact
    n = 4000
    x, y, z, h, keys, box = _setup(n, periodic=True, hval=0.05)
    level = choose_cell_level(box, 0.05)
    assert level >= 3
    counts, overflow = cell_list_neighbor_counts(
        keys, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(h),
        box, level, cap=_tight_cap(keys, level),
    )
    assert not bool(overflow)
    expected, _, _ = brute_force_counts(x, y, z, h, (-1, 1, -1, 1, -1, 1), True)
    np.testing.assert_array_equal(np.asarray(counts), expected)


def _counts_both(use_stencil, keys, x, y, z, h, box, level, cap):
    """The entry point's counts with the plain stencil and with the
    kernel in interpret mode."""
    out = []
    for stencil in (stencil_xla, KERNEL):
        use_stencil(stencil)
        counts, ovf = cell_list_neighbor_counts(
            keys, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
            jnp.asarray(h), box, level, cap=cap,
        )
        assert not bool(ovf)
        out.append(np.asarray(counts))
    return out


@pytest.mark.parametrize("periodic", [False, True])
def test_pallas_stencil_matches_xla(periodic, use_stencil):
    # the Pallas kernel (interpret mode on CPU) must agree with the XLA
    # roll stencil, which is oracle-verified above
    n = 1500
    x, y, z, h, keys, box = _setup(n, periodic, seed=77)
    level = 2  # D=4 grid
    cap = max(64, _tight_cap(keys, level))
    counts_xla, counts_pl = _counts_both(
        use_stencil, keys, x, y, z, h, box, level, cap)
    np.testing.assert_array_equal(counts_pl, counts_xla)


@pytest.mark.parametrize("periodic", [False, True])
def test_pallas_stencil_variants_match_xla(periodic, use_stencil):
    # uniform h at a cap that is not a power of two: the kernel pads the
    # ELL rows and must still agree with the XLA roll stencil
    n = 1500
    x, y, z, h, keys, box = _setup(n, periodic, seed=99, hval=0.09)
    level = 2
    cap = _tight_cap(keys, level) + 8
    assert cap & (cap - 1), "the case must exercise the padding"
    counts_xla, counts_pl = _counts_both(
        use_stencil, keys, x, y, z, h, box, level, cap)
    np.testing.assert_array_equal(counts_pl, counts_xla)


def test_rowmajor_perm_matches_jax_encode():
    # the pure-NumPy cell encode must agree with the library's jax encode
    from cstone_tpu.sfc.encode import isfc_key_top
    from cstone_tpu.traversal.celllist import _rowmajor_cell_perm_np

    level = 3
    d = 1 << level
    ij = np.arange(d, dtype=np.uint32)
    ix, iy, iz = np.meshgrid(ij, ij, ij, indexing="ij")
    lmax = max_tree_level(np.dtype(np.uint32))
    ls = np.uint32(lmax - level)
    for curve in ("hilbert", "morton"):
        perm, inv = _rowmajor_cell_perm_np(level, curve)
        ref = np.asarray(
            isfc_key_top(
                jnp.asarray(ix.ravel() << ls),
                jnp.asarray(iy.ravel() << ls),
                jnp.asarray(iz.ravel() << ls),
                level, lmax, curve,
            )
        ).astype(np.int32)
        np.testing.assert_array_equal(perm, ref)
        np.testing.assert_array_equal(perm[inv], np.arange(d**3))


def test_choose_cell_level_bounds():
    box = make_box(0.0, 1.0, boundaries=PERIODIC)
    assert choose_cell_level(box, 0.012) == 5
    assert choose_cell_level(box, 0.3) == 2  # clamped floor
    assert choose_cell_level(box, 1e-9) == 7  # clamped ceiling


def test_sym_kernel_threshold_pair_flip_is_bounded():
    """Pins the threshold-flip bound between the kernel and the plain
    stencil. A pair crossing a periodic boundary has two f32 orientation
    values of d2 (ghost b at cb - L seen from a, ghost a at ca + L seen
    from b); a compiler that contracts or reorders the distance sum may
    land on either side of a radius that sits between them — the
    reassociation freedom the reference accepts between its CPU and GPU
    paths. Constructs such a pair with the radius between the two values,
    then requires: non-pair counts EXACT, pair counts within +-1 of the
    plain stencil. Oracle tests elsewhere use seeds away from thresholds;
    this is the constructed witness."""
    import jax

    from cstone_tpu.sfc import compute_sfc_keys
    from cstone_tpu.traversal.celllist import (
        ell_pack_gather,
        rowmajor_cell_perm,
    )

    f32 = np.float32
    L = f32(1.0)
    rng = np.random.RandomState(0)
    # search a boundary pair whose two f32 orientation evaluations differ
    a = b = None
    for _ in range(10000):
        ca = f32(rng.uniform(0.001, 0.004))
        cb = f32(rng.uniform(0.996, 0.999))
        d1 = f32(ca - f32(cb - L))   # a's view: ghost b at cb - L
        d2 = f32(cb - f32(ca + L))   # b's view: ghost a at ca + L
        if f32(d1 * d1) != f32(d2 * d2):
            a, b = ca, cb
            break
    assert a is not None, "no 1-ulp asymmetric pair found"
    d1 = f32(a - f32(b - L))
    d2 = f32(b - f32(a + L))
    r2_pair = max(f32(d1 * d1), f32(d2 * d2))  # one orientation in, one out

    # fillers far from the boundary and from each other: zero neighbors
    nf = 30
    fill = (0.2 + 0.6 * (np.arange(nf) / nf)).astype(f32)
    x = np.concatenate([[a, b], fill]).astype(f32)
    y = np.full_like(x, 0.53125)
    z = np.full_like(x, 0.53125)
    box = make_box(0.0, 1.0, boundaries=PERIODIC)
    keys = compute_sfc_keys(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), box, jnp.uint64)
    order = np.argsort(np.asarray(keys), kind="stable")
    ks = jnp.asarray(np.asarray(keys)[order])
    xs, ys, zs = (jnp.asarray(v[order]) for v in (x, y, z))
    r2v = jnp.full(x.shape, r2_pair, jnp.float32)

    level, cap = 2, 64
    perm, _ = rowmajor_cell_perm(level)
    (px, py, pz, pr2), valid, pidx, ovf = ell_pack_gather(
        ks, perm, (xs, ys, zs, r2v), cap, level)
    assert not bool(ovf)
    pr2 = jnp.where(valid, pr2, jnp.float32(-1.0))
    periodic = (True, True, True)

    args = ((px, py, pz, pr2), (px, py, pz), box.lengths, periodic, level)
    sym = KERNEL(*args)
    xla = stencil_xla(*args)

    def back(counts_ell):
        ps, cs = jax.lax.sort(
            (pidx.reshape(-1), counts_ell.reshape(-1)), num_keys=1)
        return np.asarray(cs[: x.shape[0]])

    sym_c, xla_c = back(sym), back(xla.astype(jnp.int32))
    is_pair = np.isin(np.asarray(xs), [a, b])
    # fillers: bit-exact agreement required
    np.testing.assert_array_equal(sym_c[~is_pair], xla_c[~is_pair])
    # the constructed threshold pair: at most the documented 1-count flip
    assert np.abs(sym_c[is_pair] - xla_c[is_pair]).max() <= 1
