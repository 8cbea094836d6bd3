"""Persistent compilation cache location.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, nothing here
overrides it. Otherwise the cache lives at one fixed directory inside the
checkout (listed in .gitignore): the path is part of what makes a later
process find an earlier one's executables, so it must not depend on a
temp name, a PID or the time.
"""
from __future__ import annotations

import os
from typing import Optional

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at DEFAULT_DIR unless
    JAX_COMPILATION_CACHE_DIR is set. Returns the directory set here, or
    None when the environment variable decides."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
