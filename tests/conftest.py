"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

The tests stay on the CPU; sharding tests use XLA's forced host-platform
device count (the standard JAX pattern for testing shard_map/GSPMD logic
without a multi-device machine).  What needs the GPU is checked by
``chip_smoke.py`` at the repository root.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from piqp_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: the IPM while_loop is expensive to compile on
# the CPU backend; cache across test processes.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

# The CPU backend's compiler segfaults after enough large executables
# accumulate in one process (reproduced: the same shard_map compile that
# passes standalone crashes at the tail of the full suite).  Dropping the
# in-memory executable caches periodically keeps the process well below the
# blowup point; the persistent disk cache makes re-compiles cheap.
_TESTS_BETWEEN_CACHE_CLEARS = 25
_test_counter = {"n": 0}


def pytest_runtest_teardown(item, nextitem):
    _test_counter["n"] += 1
    if _test_counter["n"] % _TESTS_BETWEEN_CACHE_CLEARS == 0:
        jax.clear_caches()
