"""Persistent compilation cache for the entry points (chip_smoke.py,
bench.py, examples/, tools/).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here.  Otherwise the cache lives at one fixed path inside the
checkout, ``<checkout>/.jax_cache`` (git-ignored): the path is part of the
cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
