"""Global configuration for parallel-gps-tpu.

The reference implementation (pssgp) uses three configuration mechanisms:
GPflow's global dtype config, a module-global balancing-step count
(reference: pssgp/config.py:6-16), and per-experiment absl flags.  Here we
collapse the first two into this module; dtype follows JAX's ``jax_enable_x64``
switch so a single flag controls precision everywhere.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Number of diagonal-similarity balancing iterations used when compiling
# composite / high-order kernels to SDE form (reference: pssgp/config.py:6).
NUMBER_OF_BALANCING_STEPS: int = 10


def set_number_balancing_steps(n: int) -> None:
    """Set the default number of balancing iterations (reference: pssgp/config.py:9-16)."""
    global NUMBER_OF_BALANCING_STEPS
    NUMBER_OF_BALANCING_STEPS = int(n)


def enable_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
    there and nothing is changed.  Otherwise the cache goes to the fixed
    ``<repo>/.jax_cache`` (the path is part of the cache key, so it must
    not move between runs).  Deep scans take minutes to compile at
    T = 10⁶⁺, so every later process skips straight to execution.  Safe to
    call multiple times.
    """
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    path = os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", os.path.abspath(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def default_float():
    """Default floating dtype: float64 iff ``jax_enable_x64`` is on.

    Mirrors the reference's GPflow ``config.default_float()`` usage
    (reference: pssgp/kernels/base.py:19) with JAX's native switch.
    """
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
