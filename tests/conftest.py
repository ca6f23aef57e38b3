"""Test configuration: run on a virtual 8-device CPU mesh with x64 available.

Unit tests validate math on the CPU (fast, deterministic, multi-device via
``--xla_force_host_platform_device_count``), mirroring the reference's
CPU-only unit-test strategy (SURVEY.md §4). The program's GPU path is
exercised by ``chip_smoke.py``; tests marked ``gpu`` need a card and skip
without one (run them there with ``JAX_PLATFORMS=cuda,cpu``).

The compile cache follows JAX's own ``JAX_COMPILATION_CACHE_DIR`` when it is
set; tests set no default cache.
"""

import os

# Must be set before the first jax backend initialization.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled-executable caches between test modules.

    With the full suite in one process (~170 tests, hundreds of compiled
    while_loop programs) the XLA CPU compiler eventually crashes
    (SIGABRT/SIGSEGV inside backend_compile, position-dependent, every test
    passing in isolation) and resident memory grows by gigabytes. Clearing
    per module bounds compiler state; cross-module cache hits are rare, so
    the runtime cost is small."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (JAX found none)")
    return gpus[0]
