"""Persistent XLA compilation cache.

A persistent cache makes every repeated (shape, engine) compile -- across
tier jumps, engine resizes and reruns -- a cache load.  The reference has
no analogue (nvcc compiles each model ahead of time, README.md:10); this
is the JIT-world equivalent.

Where the cache lives is decided here and nowhere else:
``$JAX_COMPILATION_CACHE_DIR`` when it is set, else :data:`DEFAULT_DIR`,
one fixed directory inside the checkout (listed in ``.gitignore``).  A
fixed path matters: the path is part of what makes a later run find the
entries again.
"""
import os

import jax

__all__ = ["enable_compilation_cache", "cache_dir", "DEFAULT_DIR"]

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir():
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else :data:`DEFAULT_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache(min_compile_secs=1.0):
    """Route XLA compilations through the persistent on-disk cache at
    :func:`cache_dir`.  Safe to call more than once; returns the path."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
