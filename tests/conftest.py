"""Test harness configuration.

Unit tests run on the CPU — fast, single-tenant, and with a virtual
8-device mesh so multi-device sharding is validated without hardware — so
the platform is pinned via jax.config BEFORE any backend initializes.

float64 is enabled so the scipy oracle can act as a tight golden reference;
solver code is dtype-polymorphic and f32 paths are exercised by passing f32
inputs explicitly.

chip_smoke.py runs the tests marked `gpu` inside its own process on the
card; it sets MPC_ROS_TESTS_ON_DEVICE=1, and then nothing here touches the
platform or dtype configuration. Whether a card is present is decided in
the `gpu` fixture, never at import or collection time.
"""

import os

ON_DEVICE = bool(os.environ.get("MPC_ROS_TESTS_ON_DEVICE"))

if not ON_DEVICE:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first device if it is a GPU; the test skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (chip_smoke.py runs it on the card)")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _bound_jax_compile_accumulation():
    """Clear JAX's executable/tracing caches after every test module.

    The full suite compiles ~hundreds of XLA CPU programs in one process;
    with all of them held live, the CPU compiler deterministically
    segfaults partway through the run (reproduced at HEAD across three
    full-suite runs, always inside backend_compile, while every subset of
    the suite passes — an upstream XLA CPU issue triggered by accumulated
    compiled-program state, not by any single test). Dropping the caches
    at module boundaries bounds that accumulation; modules re-jit shared
    helpers, costing ~10-20% suite runtime.

    Repro for upstream: `tools/repro_xla_cpu_segfault.sh` runs the suite
    with this fixture disabled (MPC_ROS_TPU_NO_CACHE_CLEAR=1) — expect a
    hard crash partway through. A synthetic attempt with 500 distinct
    SMALL programs (scan + while_loop + matmul each) did NOT reproduce,
    so the trigger needs the suite's large solver programs, not sheer
    program count."""
    yield
    if not os.environ.get("MPC_ROS_TPU_NO_CACHE_CLEAR"):
        jax.clear_caches()
        gc.collect()
