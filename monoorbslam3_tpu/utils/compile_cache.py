"""Persistent XLA compile cache for the entry points.

A cold start compiles every jitted program of the tracking and mapping
path; the persistent cache keeps those executables on disk so the next
process loads them instead. The cache key includes the directory, so the
default is one fixed path inside the checkout (git-ignored), never a
temporary or per-process one.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turns the persistent compile cache on and returns its directory.

    If `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and this
    sets nothing; otherwise the cache goes to `DEFAULT_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
