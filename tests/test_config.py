"""Where the compile cache goes, and that float64 stays on the device JAX
picked (no silent move to the CPU)."""
import os

import jax
import pytest

from parallel_gps_tpu import config


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = []
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.append((name, value))
    )
    return calls


def test_compile_cache_follows_environment(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    config.enable_compilation_cache()
    assert config_updates == []  # JAX reads the variable itself


def test_compile_cache_default_is_fixed_repo_path(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    config.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert ("jax_compilation_cache_dir", os.path.join(repo, ".jax_cache")) in (
        config_updates
    )
    assert [n for n, _ in config_updates if n == "jax_compilation_cache_dir"] == [
        "jax_compilation_cache_dir"
    ]


@pytest.mark.parametrize(
    "dtype,platform,want_platform",
    [
        ("float64", None, None),
        ("float64", "default", None),
        ("float32", None, None),
        ("float64", "cpu", "cpu"),
    ],
    ids=["f64-default", "f64-named-default", "f32-default", "f64-cpu"],
)
def test_set_dtype_keeps_the_device(
    monkeypatch, config_updates, dtype, platform, want_platform
):
    """set_dtype("float64") enables x64 without forcing the CPU: only an
    explicit --platform cpu selects the host."""
    from parallel_gps_tpu.experiments import common

    monkeypatch.setattr(config, "enable_compilation_cache", lambda: None)
    common.set_dtype(dtype, platform)
    assert ("jax_enable_x64", dtype == "float64") in config_updates
    platforms = [v for n, v in config_updates if n == "jax_platforms"]
    assert platforms == ([] if want_platform is None else [want_platform])
