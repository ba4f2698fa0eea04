"""Where the persistent JAX compilation cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set the program
leaves the cache alone. Otherwise the cache goes to a fixed directory inside
the checkout (listed in ``.gitignore``): the path is part of the cache key,
so a directory that moves between runs never hits.
"""
from __future__ import annotations

import os
from typing import Optional

import jax

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent cache at ``CHECKOUT_CACHE_DIR`` unless the
    environment names one, and return the directory it set (None when it
    set nothing). Call before the first compilation."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    # only the large programs: the flagship step and its pieces
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 10)
    return CHECKOUT_CACHE_DIR
