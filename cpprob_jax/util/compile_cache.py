"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and nothing
else is configured.  Otherwise the cache goes to ``<repo>/.jax_cache`` (listed
in ``.gitignore``): a fixed path, so later runs from the same checkout find
what earlier ones compiled."""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "default_cache_dir"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory.  Call before the
    first compilation of the process."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
