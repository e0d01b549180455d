"""Placement of JAX's persistent compilation cache.

The cache's path is part of its key, so it must not move between runs: a
directory named after the host, the process or the time never hits again.
Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the
program sets nothing; otherwise the cache lives in ``.jax_cache`` at the
root of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str | None:
    """The directory this process has to set, or None when the environment
    already names one."""
    if os.environ.get(ENV_VAR):
        return None
    return str(CHECKOUT_CACHE)


def enable_compile_cache() -> str:
    """Point JAX at the persistent cache; returns the directory in use."""
    path = cache_dir()
    if path is None:
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
