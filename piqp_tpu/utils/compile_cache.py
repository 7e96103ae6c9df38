"""Persistent compilation cache for the repository's scripts and tests.

The package itself sets no cache.  Entry points that compile the solver
many times (``chip_smoke.py``, ``bench.py``, ``benchmarks/*``, the test
suite) call :func:`enable_compile_cache` once, before the first compile.

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it on its own, and no other
  directory is set in code.
- Otherwise the cache lives in ``<checkout>/.jax_cache`` (listed in
  ``.gitignore``).  The path is fixed, so later processes hit the entries
  that earlier ones wrote.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
