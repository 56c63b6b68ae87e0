"""Named particle fields with acquire/release lifetime states.

JAX equivalent of the reference's field helpers (reference:
include/cstone/fields/field_states.hpp:62-104, field_get.hpp:42-89,
data_util.hpp:41). The reference reuses released buffers to avoid
allocation; with JAX's functional arrays the same contract becomes a
named-slot registry: `release` returns a field's storage slot to a pool,
`acquire` binds a pooled slot of matching shape/dtype to a new name.
XLA's buffer donation then provides the actual in-place reuse.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = ["FieldStates", "ParticleFields", "get_fields"]

CONSERVED = "conserved"
DEPENDENT = "dependent"
RELEASED = "released"


class FieldStates:
    """Tracks which fields are conserved / dependent / released
    (field_states.hpp:62-104)."""

    def __init__(self):
        self._states: Dict[str, str] = {}

    def add(self, name: str, state: str = DEPENDENT):
        self._states[name] = state

    def set_conserved(self, *names: str):
        for n in names:
            self._states[n] = CONSERVED

    def set_dependent(self, *names: str):
        for n in names:
            self._states[n] = DEPENDENT

    def release(self, *names: str):
        for n in names:
            if self._states.get(n) == CONSERVED:
                raise ValueError(f"cannot release conserved field {n!r}")
            self._states[n] = RELEASED

    def is_allocated(self, name: str) -> bool:
        return self._states.get(name) in (CONSERVED, DEPENDENT)

    def state(self, name: str) -> str | None:
        return self._states.get(name)

    def conserved(self) -> List[str]:
        return [n for n, s in self._states.items() if s == CONSERVED]

    def dependent(self) -> List[str]:
        return [n for n, s in self._states.items() if s == DEPENDENT]


class ParticleFields:
    """A named collection of per-particle arrays with lifetime states.

    The compile-time `get<"x","y">(dataset)` of the reference
    (field_get.hpp:42-89) becomes name-based lookup; acquire/release mirror
    the memory-reuse contract of FieldStates.
    """

    def __init__(self, n: int, dtype=jnp.float32):
        self.n = int(n)
        self.default_dtype = dtype
        self._data: Dict[str, jax.Array] = {}
        self._pool: List[jax.Array] = []
        self.states = FieldStates()

    # -- allocation -----------------------------------------------------
    def add(self, name: str, value=None, dtype=None, conserved: bool = False):
        if value is None:
            value = jnp.zeros((self.n,), dtype=dtype or self.default_dtype)
        self._data[name] = value
        self.states.add(name, CONSERVED if conserved else DEPENDENT)
        return value

    def acquire(self, *names: str, dtype=None):
        """Bind released storage (or fresh zeros) to new names
        (field_states.hpp acquire)."""
        dt = dtype or self.default_dtype
        for name in names:
            reused = None
            for i, buf in enumerate(self._pool):
                if buf.dtype == dt and buf.shape == (self.n,):
                    reused = self._pool.pop(i)
                    break
            self._data[name] = (
                reused if reused is not None else jnp.zeros((self.n,), dtype=dt)
            )
            self.states.add(name, DEPENDENT)

    def release(self, *names: str):
        self.states.release(*names)
        for name in names:
            buf = self._data.pop(name, None)
            if buf is not None:
                self._pool.append(buf)

    # -- access -----------------------------------------------------------
    def __getitem__(self, name: str) -> jax.Array:
        return self._data[name]

    def __setitem__(self, name: str, value: jax.Array):
        if name not in self._data:
            self.add(name, value)
        else:
            self._data[name] = value

    def get(self, *names: str) -> Tuple[jax.Array, ...]:
        return tuple(self._data[n] for n in names)

    def names(self) -> List[str]:
        return list(self._data.keys())

    def field_index(self, name: str, field_names: Sequence[str]) -> int:
        """constexpr getFieldIndex analog (data_util.hpp:41)."""
        return list(field_names).index(name)


def get_fields(dataset: ParticleFields, *names: str) -> Tuple[jax.Array, ...]:
    """get<"x","y">(dataset) analog (field_get.hpp:42-89)."""
    return dataset.get(*names)
