"""Checkpoint round-trip + timer tests."""

import jax.numpy as jnp
import numpy as np

from cstone_tpu.domain.domain import Domain
from cstone_tpu.utils import (
    Timer,
    configure_compile_cache,
    load_checkpoint,
    save_checkpoint,
)


def test_checkpoint_roundtrip(tmp_path):
    domain = Domain(rank=0, n_ranks=1, bucket_size=16, key_dtype=jnp.uint64,
                    tree_capacity=256)
    state = domain.init_state()
    p = tmp_path / "ckpt"
    save_checkpoint(p, state)
    restored = load_checkpoint(p, state)
    np.testing.assert_array_equal(
        np.asarray(restored.global_tree.keys), np.asarray(state.global_tree.keys)
    )
    np.testing.assert_array_equal(
        np.asarray(restored.box.limits), np.asarray(state.box.limits)
    )
    assert restored.box.boundaries == state.box.boundaries


def test_timer():
    t = Timer()
    out = t.stage("add", lambda a: a + 1, jnp.arange(10))
    assert "add" in t.times and t.times["add"] >= 0
    assert "total" in t.report()


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    import jax

    from cstone_tpu.utils.compile_cache import REPO_CACHE_DIR

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = configure_compile_cache()
    assert got == str(REPO_CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == got
    assert REPO_CACHE_DIR.name == ".cstone_jax_cache"
    assert (REPO_CACHE_DIR.parent / "cstone_tpu").is_dir()


def test_compile_cache_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert configure_compile_cache() == str(tmp_path)
    # no directory is set in code where the variable names one
    assert jax.config.jax_compilation_cache_dir == before
