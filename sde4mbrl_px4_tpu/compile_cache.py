"""Shared persistent-compile-cache bootstrap.

One agreed cache location for every entry point (bench, examples, launch,
tests, ``chip_smoke.py``): solver compiles dominate node bring-up (the
reference logs the same hot spot, ``sde_control.py:695-720``), so warming
the cache in ANY entry point must benefit all of them.

The location is placed from outside: ``JAX_COMPILATION_CACHE_DIR`` when it
is set, else the fixed ``<checkout>/.jax_cache`` (listed in
``.gitignore``). The path is part of the cache's key, so it never moves
with the working directory.
"""
from __future__ import annotations

import os

__all__ = ["ensure_compile_cache", "default_cache_dir"]


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache`` — the cache used when
    ``JAX_COMPILATION_CACHE_DIR`` is unset."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo, ".jax_cache")


def ensure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``JAX_COMPILATION_CACHE_DIR`` if set, else at :func:`default_cache_dir`,
    and return the path.

    Works whether or not jax is already imported: JAX reads the env var
    once, when it is imported, so the directory is also pushed through
    ``jax.config.update`` — valid any time before the first compilation.
    The env var is exported so child processes share the same cache.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or default_cache_dir()
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    import jax

    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
