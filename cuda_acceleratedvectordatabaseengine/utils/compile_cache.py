"""JAX's persistent compilation cache, in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands (JAX
reads it itself) and nothing else is configured. Otherwise the cache lives
at a fixed path inside the checkout (``.jax_cache/``, git-ignored): the path
is part of the cache key, so a stable directory is what makes a second run
of the same program skip compilation.
"""

from __future__ import annotations

import os

_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory."""
    path = os.environ.get(_ENV)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
