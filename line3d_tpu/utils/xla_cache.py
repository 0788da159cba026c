"""Persistent XLA compilation cache.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, the program
uses that directory and sets none in code.  Otherwise the cache goes to one
fixed directory inside the checkout (`.jax_cache/`, git-ignored): the
path is part of the cache key, so a fixed path lets repeat runs from the
same checkout reuse their compiled programs.
"""
from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str | None:
    """The directory this module sets, or None when the environment
    already names one."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE_DIR


def enable_persistent_cache() -> None:
    """Point jax's on-disk compilation cache at cache_dir() (idempotent;
    must run before the first compilation to matter)."""
    path = cache_dir()
    if path is not None:
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
