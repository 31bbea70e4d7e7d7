"""JAX's persistent compilation cache for the program's entry points.

``bench.py``, ``chip_smoke.py`` and the CLI call :func:`enable_compile_cache`
once at start-up; importing the library enables nothing. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no other
directory is set. Otherwise the cache lives at a fixed ``<repo>/.jax_cache``
(the path is part of the cache's key, so it must not move between runs).
The cache is turned on for the GPU backend only: CPU runs, the test suite
among them, compile without it.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir() -> str:
    """The directory the cache uses: ``$JAX_COMPILATION_CACHE_DIR`` if set,
    else ``<repo>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str | None:
    """Turn the persistent cache on for a GPU backend; returns its
    directory, or None where it stays off (any other backend)."""
    if jax.default_backend() != "gpu":
        return None
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    return cache_dir()
