"""Simple stage timing.

The reference's perf drivers use std::chrono + CUDA events (reference:
test/performance/timing.cuh). JAX dispatch is asynchronous, so
Timer.stage waits for its result with jax.block_until_ready before it
reads the clock.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import jax

__all__ = ["Timer"]


class Timer:
    def __init__(self):
        self.times: Dict[str, float] = {}

    def stage(self, name: str, fn: Callable, *args, **kwargs) -> Any:
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - t0)
        return out

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v*1000:.1f} ms" for k, v in self.times.items()]
        lines.append(f"total: {total*1000:.1f} ms")
        return "\n".join(lines)
