"""Persistent XLA compile cache for the program's entry points."""

from __future__ import annotations

import os

# the checkout root (the directory holding the package)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here; otherwise the cache lives at the fixed
    ``<checkout>/.jax_cache`` (a fixed path, since the path is part of the
    cache key)."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
