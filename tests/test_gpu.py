"""Checks that need an NVIDIA GPU (marker `gpu`; they skip elsewhere): the
compiled Pallas kernel against the plain XLA stencil, and the main path
against the f64 oracle, at a mid size. chip_smoke.py runs the same checks
at the timed size. Run on a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import pytest

import chip_smoke as cs
from cstone_tpu.ops.pallas_stencil import stencil_pallas
from cstone_tpu.sfc import PERIODIC, make_box
from cstone_tpu.traversal.celllist import choose_cell_level, default_cell_cap

N = 200_000


def _config(n):
    h = cs.SYNC_H * (cs.SYNC_N / n) ** (1.0 / 3.0)
    level = choose_cell_level(make_box(0.0, 1.0, boundaries=PERIODIC), h)
    return h, level, default_cell_cap(n, level, snapshots=3)


@pytest.mark.gpu
def test_kernel_matches_plain_on_gpu(gpu):
    _, level, cap = _config(N)
    cs.check_kernels(stencil_pallas, N, level, cap)


@pytest.mark.gpu
def test_main_path_matches_oracle_on_gpu(gpu):
    h, level, cap = _config(N)
    last = cs.time_main_paths(N, h, level, cap, stencil_pallas, steps=2)
    cs.check_main_path_oracle(last, 256)
