"""Checkpoint/resume for Domain state and particle fields.

The reference only exposes a serialization hook on Box (reference:
include/cstone/sfc/box.hpp:167-175, loadOrStore) and leaves particle data
to the client. Here the whole DomainState is a pytree, so checkpointing is
uniform: any pytree (DomainState, particle field dicts, model states) is
saved to and restored from one numpy .npz file.
"""

from __future__ import annotations

import pathlib
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path, tree: Any) -> None:
    """Save a pytree of arrays to `path` with the .npz suffix."""
    path = pathlib.Path(path)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    np.savez(
        path.with_suffix(".npz"),
        __treedef__=np.frombuffer(repr(treedef).encode(), dtype=np.uint8),
        **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)},
    )


def load_checkpoint(path, like: Any) -> Any:
    """Load a pytree saved by save_checkpoint; `like` provides the structure."""
    path = pathlib.Path(path)
    data = np.load(path.with_suffix(".npz"))
    leaves, treedef = jax.tree_util.tree_flatten(like)
    loaded = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, loaded)
