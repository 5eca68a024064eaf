"""Where the persistent XLA compile cache lives.

One rule for every entry point: `JAX_COMPILATION_CACHE_DIR` when it is set,
otherwise a fixed directory inside the checkout (`.jax_cache/`, gitignored).
The path is part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compile cache at `cache_dir()`; returns it.
    Only programs that took at least `min_compile_secs` to compile are kept."""
    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return d
