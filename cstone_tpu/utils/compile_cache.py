"""Where the persistent XLA compile cache lives.

A compile cache only hits when its directory stays the same between runs
(the path is part of the key), and code of this repo writes nothing
outside its checkout. So: JAX_COMPILATION_CACHE_DIR where it is set (JAX
reads the variable itself, and no directory is set in code), otherwise
the fixed in-repo `.cstone_jax_cache/`, which .gitignore lists.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["REPO_CACHE_DIR", "configure_compile_cache"]

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".cstone_jax_cache"


def configure_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compile cache at its directory (see the
    module docstring) and cache every program that took at least
    `min_compile_secs` to compile. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        cache_dir = env
    else:
        cache_dir = str(REPO_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_secs))
    return cache_dir
