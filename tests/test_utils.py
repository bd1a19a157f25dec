"""Checkpointing and profiling utilities."""
import os

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt

from parallel_gps_tpu.kernels import Matern32
from parallel_gps_tpu.utils.checkpoint import load_pytree, save_pytree
from parallel_gps_tpu.utils.profiling import timed


def test_pytree_checkpoint_round_trip(tmp_path):
    tree = {
        "kernel": Matern32(variance=jnp.asarray(1.5), lengthscales=jnp.asarray(0.3)),
        "noise_variance": jnp.asarray(0.07),
        "history": jnp.arange(5.0),
    }
    path = os.path.join(tmp_path, "ckpt", "params.npz")
    save_pytree(path, tree)
    like = {
        "kernel": Matern32(variance=jnp.zeros(()), lengthscales=jnp.zeros(())),
        "noise_variance": jnp.zeros(()),
        "history": jnp.zeros((5,)),
    }
    restored = load_pytree(path, like)
    npt.assert_allclose(float(restored["kernel"].variance), 1.5)
    npt.assert_allclose(float(restored["kernel"].lengthscales), 0.3)
    npt.assert_allclose(float(restored["noise_variance"]), 0.07)
    npt.assert_allclose(np.asarray(restored["history"]), np.arange(5.0))


def test_pytree_checkpoint_rejects_structure_mismatch(tmp_path):
    import pytest

    path = os.path.join(tmp_path, "params.npz")
    save_pytree(path, {"a": jnp.ones(3), "b": jnp.zeros(())})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, {"a": jnp.ones(3), "c": jnp.zeros(())})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, [jnp.ones(3), jnp.zeros(())])


def test_timed_blocks_on_sync():
    x = jnp.ones((64, 64))
    results = {}
    with timed("matmul", results) as box:
        box["sync"] = x @ x
    assert results["matmul"] > 0.0


def test_split_device_model_placement():
    """--split-devices protocol: ssgp pins to the host CPU device, pssgp/gp
    keep default placement, in float32 and float64 alike (the accelerator
    runs float64 natively); only --platform cpu collapses the split.
    Reference study maps
    GP/SSGP/PSSGP to distinct devices in ONE process
    (pssgp/experiments/toy_models/speed_and_stability.py:71-95)."""
    import jax

    from parallel_gps_tpu.experiments import common as C

    cpu0 = jax.devices("cpu")[0]
    assert C.resolve_model_device("ssgp", None, "float32") == cpu0
    assert C.resolve_model_device("pssgp", None, "float32") is None
    assert C.resolve_model_device("gp", None, "float32") is None
    assert C.resolve_model_device("ssgp", None, "float64") == cpu0
    assert C.resolve_model_device("pssgp", None, "float64") is None
    assert C.resolve_model_device("ssgp", "cpu", "float32") is None

    t = np.sort(np.random.RandomState(0).rand(64))
    y = np.sin(2 * np.pi * t)
    model = C.get_model("ssgp", (t, y), Matern32(1.0, 0.5), 0.1, device=cpu0)
    assert all(
        cpu0 in leaf.devices()
        for leaf in jax.tree.leaves(model)
        if hasattr(leaf, "devices")
    )
    mean, var = model.predict_f(np.linspace(0.1, 0.9, 16))
    assert np.all(np.isfinite(np.asarray(mean)))
    assert np.all(np.asarray(var) > 0)
