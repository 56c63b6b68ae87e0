"""Utilities: checkpointing, timing, the compile-cache location."""

from .checkpoint import load_checkpoint, save_checkpoint
from .compile_cache import configure_compile_cache
from .timing import Timer
