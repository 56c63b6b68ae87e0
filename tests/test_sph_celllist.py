"""Fused SPH density stencil vs brute-force oracle.

The density interaction runs INSIDE the cell-list stencil
(op="density", here the Pallas kernel in interpret mode) — validated
against an O(n^2)
reference of the same formula rho_i = (m/pi h_i^3)(sum_j W(|r_ij|/h_i) +
W(0)), cubic-spline W, periodic and open boundaries, uniform and
per-particle h (reference semantics: the per-pair op of
find_neighbors.cuh:94-124 combined with findneighbors.hpp:96-165 distances).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cstone_tpu.traversal.celllist import (
    cell_list_sph_density,
    choose_cell_level,
)
from tests.test_celllist import _tight_cap
from tests.test_neighbors import _setup

MASS = 0.37


def _w_cubic(q):
    w1 = 1.0 - 1.5 * q * q * (1.0 - 0.5 * q)
    w2 = 0.25 * (2.0 - q) ** 3
    return np.where(q < 1.0, w1, np.where(q < 2.0, w2, 0.0))


def brute_density(x, y, z, h, periodic):
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    z = z.astype(np.float64)
    h = h.astype(np.float64)
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    dz = z[:, None] - z[None, :]
    if periodic:
        L = 2.0
        dx -= L * np.round(dx / L)
        dy -= L * np.round(dy / L)
        dz -= L * np.round(dz / L)
    r = np.sqrt(dx * dx + dy * dy + dz * dz)
    q = r / h[:, None]
    w = _w_cubic(q)
    np.fill_diagonal(w, 0.0)
    return (MASS / np.pi / h**3) * (w.sum(axis=1) + _w_cubic(np.zeros(1))[0])


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("const_h", [False, True])
def test_cell_list_density_vs_bruteforce(periodic, const_h, interpret_kernel):
    n = 1200
    x, y, z, h, keys, box = _setup(
        n, periodic, seed=31, hval=0.09 if const_h else None
    )
    level = choose_cell_level(box, float(h.max()))
    cap = -(-max(64, _tight_cap(keys, level)) // 64) * 64
    rho, ovf = cell_list_sph_density(
        keys, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(h),
        box, level, cap=cap, mass=MASS,
    )
    assert not bool(ovf)
    expected = brute_density(x, y, z, h, periodic)
    np.testing.assert_allclose(
        np.asarray(rho), expected, rtol=2e-4, atol=1e-6 * expected.max()
    )


def brute_density_m(x, y, z, h, m, periodic):
    x = x.astype(np.float64); y = y.astype(np.float64)
    z = z.astype(np.float64); h = h.astype(np.float64)
    m = m.astype(np.float64)
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    dz = z[:, None] - z[None, :]
    if periodic:
        L = 2.0
        dx -= L * np.round(dx / L)
        dy -= L * np.round(dy / L)
        dz -= L * np.round(dz / L)
    r = np.sqrt(dx * dx + dy * dy + dz * dz)
    w = _w_cubic(r / h[:, None])
    np.fill_diagonal(w, 0.0)
    return (1.0 / np.pi / h**3) * (
        (w * m[None, :]).sum(axis=1) + m * _w_cubic(np.zeros(1))[0]
    )


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("const_h", [False, True])
def test_cell_list_density_per_particle_mass(periodic, const_h,
                                            interpret_kernel):
    # the kernel's candidate mass plane: rho_i sums the NEIGHBOR's m_j
    # (find_neighbors.cuh:94-124's per-particle payload); const_h selects
    # a uniform-h sample
    n = 1100
    x, y, z, h, keys, box = _setup(
        n, periodic, seed=77, hval=0.09 if const_h else None
    )
    rng = np.random.RandomState(5)
    # keys/arrays from _setup are already key-sorted and aligned
    m = rng.uniform(0.2, 1.7, size=n).astype(np.float32)
    level = choose_cell_level(box, float(h.max()))
    cap = -(-max(64, _tight_cap(keys, level)) // 64) * 64
    rho, ovf = cell_list_sph_density(
        keys, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(h),
        box, level, cap=cap, mass=jnp.asarray(m),
    )
    assert not bool(ovf)
    expected = brute_density_m(x, y, z, h, m, periodic)
    np.testing.assert_allclose(
        np.asarray(rho), expected, rtol=2e-4, atol=1e-6 * expected.max()
    )
