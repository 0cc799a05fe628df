"""Test configuration: run everything on a virtual 8-device CPU mesh.

The tests pin JAX to the CPU platform (with 8 virtual devices for the
sharding tests) before any backend is initialized; `chip_smoke.py` is
the check that runs on the GPU.
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


# A full single-process run compiles thousands of XLA:CPU executables;
# past ~470 tests the next backend_compile_and_load deterministically
# segfaults inside XLA (reproduced on two unrelated code revisions and
# under MALLOC_CHECK_, with 120 GB RAM free — an XLA resource limit,
# not a leak in this package).  Dropping the cached executables every
# ~120 tests keeps the loaded-code volume bounded; the persistent
# compilation cache makes re-compiles cheap.
import pytest  # noqa: E402

_test_counter = {"n": 0}


@pytest.fixture(autouse=True)
def _bound_xla_code_volume():
    yield
    _test_counter["n"] += 1
    if _test_counter["n"] % 120 == 0:
        import jax as _jax
        _jax.clear_caches()
