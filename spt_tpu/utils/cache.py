"""Persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache there and
this module sets no other directory.  Otherwise the cache lives in a fixed
``.jax_cache/`` at the repository root: the path is part of the cache key,
so a directory that moved between runs would never hit.

Enabled on the product surfaces (CLI, bench, chip_smoke) and by the tests
via :func:`enable_default_cache`.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def cache_dir() -> str:
    """Where compiled programs are cached."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE


def enable_default_cache() -> None:
    """Turn on JAX's persistent cache for programs that take over a second
    to compile, in :func:`cache_dir`."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(REPO_CACHE, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
