"""Test configuration: run on a virtual 8-device CPU mesh by default.

Multi-device sharding is exercised on host CPU devices
(xla_force_host_platform_device_count), exactly as __graft_entry__.py's
dryrun_multichip does. JAX_PLATFORMS, where set, picks the platform
instead: `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` runs the
tests that need a card (marker `gpu`, see pytest.ini).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import json
import pathlib

import jax
import numpy as np
import pytest

from cstone_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache(min_compile_secs=0.5)

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden():
    """Reference-implementation golden vectors (see tests/oracle/)."""
    with open(GOLDEN_DIR / "reference_golden.json") as f:
        raw = json.load(f)
    out = {}
    for k, v in raw.items():
        if "64" in k or k.startswith("spanning"):
            out[k] = np.asarray(v, dtype=np.uint64)
        else:
            out[k] = np.asarray(v, dtype=np.uint32)
    return out


@pytest.fixture
def use_stencil(monkeypatch):
    """use_stencil(fn): the cell-list entry points run stencil fn."""
    from cstone_tpu.traversal import celllist

    def use(fn):
        monkeypatch.setattr(celllist, "_stencil_override", fn)

    return use


@pytest.fixture
def interpret_kernel(use_stencil):
    """The cell-list entry points run the Pallas kernel in interpret mode."""
    from functools import partial

    from cstone_tpu.ops.pallas_stencil import stencil_pallas

    use_stencil(partial(stencil_pallas, interpret=True))


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip(f"needs a GPU (JAX platform {jax.default_backend()!r})")
    return devices[0]
