"""chip_smoke.py's phases at tiny sizes on the CPU: the same checks the
script runs on the card, with the Pallas kernel in interpret mode. Only
the device assertion differs: here it must refuse the CPU."""

from functools import partial

import jax
import pytest

import chip_smoke as cs
from cstone_tpu.ops.pallas_stencil import stencil_pallas
from cstone_tpu.sfc import PERIODIC, make_box
from cstone_tpu.traversal.celllist import choose_cell_level, default_cell_cap

KERNEL = partial(stencil_pallas, interpret=True)


def _config(n):
    h = cs.SYNC_H * (cs.SYNC_N / n) ** (1.0 / 3.0)
    level = choose_cell_level(make_box(0.0, 1.0, boundaries=PERIODIC), h)
    return h, level, default_cell_cap(n, level, snapshots=3)


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.require_gpu()


def test_main_prints_no_result_without_gpu(capsys):
    with pytest.raises(cs.SmokeFailure):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_kernel_checks_tiny():
    _, level, cap = _config(6000)
    assert cap > 64, "the case must exercise several kernel blocks"
    cs.check_kernels(KERNEL, 6000, level, cap)


@pytest.mark.parametrize("op", ["count", "density"])
def test_main_path_and_oracle_tiny(op):
    h, level, cap = _config(4000)
    last = cs.time_main_paths(4000, h, level, cap, KERNEL, steps=2,
                              ops=(op,))
    cs.check_main_path_oracle(last, 128)


def test_oracle_catches_a_wrong_count():
    h, level, cap = _config(3000)
    last = cs.time_main_paths(3000, h, level, cap, cs.stencil_xla, steps=1,
                              ops=("count",))
    x, y, z, hh, m, vals, s, e = last["count"]
    last["count"] = (x, y, z, hh, m, vals + 1.0, s, e)
    with pytest.raises(cs.SmokeFailure, match="threshold band"):
        cs.check_main_path_oracle(last, 16)


def test_octree_check_tiny():
    cs.check_octree(20000, 16, reps=1)


def test_reach_tiny(interpret_kernel):
    cs.check_reach(4000)


def test_multichip_tiny():
    assert len(jax.devices()) >= 4
    cs.check_multichip(4, 1500)
