"""Test configuration: float64, 8 virtual CPU devices, CPU by default.

The idiomatic JAX way to test sharded scans without a multi-device host:
8 fake CPU devices via ``--xla_force_host_platform_device_count``
(SURVEY.md §4).  Must run before any JAX backend initialization, hence at
conftest import time.  The platform is ``JAX_PLATFORMS`` when set (e.g.
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` on a GPU host) and
the CPU otherwise.
"""
import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the suite is compile-bound (dozens of
# distinct jitted programs); caching makes re-runs fast.  Same rule as the
# package (config.enable_compilation_cache): JAX_COMPILATION_CACHE_DIR when
# set, else the fixed <repo>/.jax_cache.
from parallel_gps_tpu.config import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a CUDA GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (run with JAX_PLATFORMS=cuda -m gpu)")
    return jax.devices()[0]
