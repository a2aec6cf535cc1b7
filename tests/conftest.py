import os

import pytest

from tudocomp_tpu.device import ensure_compile_cache

# persistent compile cache: XLA:CPU takes tens of seconds to compile each
# variadic lax.sort, so the sort-heavy staged kernels (device SA, device
# ESP) are compiled once per machine, not once per test run
ensure_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped when JAX has none"
    )
    # `-m gpu` runs the card's tests on the default backend. Every other
    # run is pinned to a virtual 8-device CPU mesh, so multi-card sharding
    # paths are exercised without an accelerator (SURVEY.md §4 test plan
    # item f). JAX reads both variables when the test modules import it.
    if config.getoption("markexpr") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX's backend has none."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"no GPU: JAX's default backend is {device.platform}")
    return device
