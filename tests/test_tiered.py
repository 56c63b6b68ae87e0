"""Tiered adaptive-h cell list vs the O(n^2) oracle.

The clustered + density-adaptive-h regime (the reference warp kernel's
target workload, find_neighbors.cuh:46-75) decomposed into per-tier and
cross-tier stencil passes — counts must stay exact (reference neighbor
definition findneighbors.hpp:96-165: d < 2*h_i, i != j).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cstone_tpu.sfc import PERIODIC, compute_sfc_keys, make_box
from cstone_tpu.traversal.tiered import (
    cell_list_neighbor_counts_tiered,
    choose_tier_levels,
    tier_caps,
)
from tests.test_neighbors import brute_force_counts


def _clustered_setup(n, periodic, seed=5):
    rng = np.random.RandomState(seed)
    # two-population sample: a tight gaussian core + uniform background —
    # h spans ~3 octaves like a Plummer profile's adaptive smoothing
    nc = n // 2
    core = np.clip(rng.normal(0.0, 0.08, size=(nc, 3)), -0.99, 0.99)
    bg = rng.uniform(-1, 1, size=(n - nc, 3))
    pos = np.concatenate([core, bg]).astype(np.float32)
    # h ~ local-density adaptive: small in the core, large outside
    r = np.linalg.norm(pos, axis=1)
    h = np.clip(0.02 + 0.09 * r, 0.02, 0.11).astype(np.float32)

    box = make_box(-1.0, 1.0, boundaries=PERIODIC if periodic else 0)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    keys = compute_sfc_keys(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), box, jnp.uint64)
    order = np.argsort(np.asarray(keys), kind="stable")
    return (x[order], y[order], z[order], h[order],
            jnp.asarray(np.asarray(keys)[order]), box, pos[order])


@pytest.mark.parametrize("periodic", [False, True])
def test_tiered_counts_vs_bruteforce(periodic, interpret_kernel):
    n = 2000
    x, y, z, h, keys, box, pos = _clustered_setup(n, periodic)
    levels = choose_tier_levels(h, 2.0, max_tiers=3)
    assert len(levels) >= 2, "setup must span at least two tiers"
    caps, cross = tier_caps(pos, h, (-1.0, 1.0), levels)
    expected, _, _ = brute_force_counts(
        x, y, z, h, (-1, 1, -1, 1, -1, 1), periodic)
    # the kernel in interpret mode; the plain stencil's cross-set leg is
    # covered by test_stencil.py and its same-tier leg below
    counts, ovf = cell_list_neighbor_counts_tiered(
        keys, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(h),
        box, levels, caps, cross,
    )
    assert not bool(ovf)
    np.testing.assert_array_equal(np.asarray(counts), expected)


def test_tiered_single_level_degenerates():
    # uniform h -> one tier: must equal the plain cell list path
    from tests.test_neighbors import _setup

    n = 1500
    x, y, z, h, keys, box = _setup(n, True, seed=7, hval=0.1)
    levels = choose_tier_levels(h, 2.0, max_tiers=3)
    assert len(levels) == 1
    caps, cross = tier_caps(
        np.stack([x, y, z], -1), h, (-1.0, 1.0), levels)
    counts, ovf = cell_list_neighbor_counts_tiered(
        keys, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(h),
        box, levels, caps, cross,
    )
    assert not bool(ovf)
    expected, _, _ = brute_force_counts(x, y, z, h, (-1, 1, -1, 1, -1, 1), True)
    np.testing.assert_array_equal(np.asarray(counts), expected)


def test_choose_tier_levels_inadmissible_raises():
    # max(h) too large for level 2 (2*h > side/4): silently clamping to an
    # inadmissible tier would undercount without raising overflow — the
    # contract is to fail loudly so callers fall back to a dense path
    h = np.array([0.01, 0.3], np.float32)  # 2*0.3 = 0.6 > 2.0/4 = 0.5
    with pytest.raises(ValueError, match="no admissible tier"):
        choose_tier_levels(h, 2.0, max_tiers=3)


def test_choose_tier_levels_tiny_h_single_finest_tier():
    # uniformly tiny h: lo would exceed max_level; must clamp to ONE
    # finest tier, not return an empty tuple
    h = np.full((100,), 0.001, np.float32)  # lo = log2(2/0.002) = 9 > 7
    levels = choose_tier_levels(h, 2.0, max_tiers=3, max_level=7)
    assert levels == (7,)
