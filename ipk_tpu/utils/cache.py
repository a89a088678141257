"""Persistent XLA compilation cache setup.

Compiling the build's programs (and the Triton combine kernel) for the GPU
takes seconds to tens of seconds per distinct shape; the persistent cache
makes repeat invocations with the same shapes start hot.

Where the cache lives: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and nothing here overrides it. Otherwise the cache goes to a fixed
path inside the checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``):
a fixed path, because the path is part of the cache key.
"""

from __future__ import annotations

import os

__all__ = ["enable_compilation_cache"]

#: the checkout that holds this package
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory in use. Call
    before the first compile."""
    import jax
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = os.path.join(_REPO, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
