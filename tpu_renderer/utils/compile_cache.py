"""The persistent XLA compilation cache, in one place.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it. Otherwise the cache lives at a fixed path inside the checkout
(`.jax_cache/`, gitignored): the directory is part of what makes a later
run find its entries, so it must not move between runs.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the cache on; returns the directory in use."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
