"""Distributed engines through the MODEL API.

``StateSpaceGP.create(..., mesh=...)`` must route LML (and its gradients,
via the sharded Fisher-identity VJP) and predict_f through the time-axis-
sharded two-level engines, matching the single-device model exactly (the
two-level combine is exact; f64 deltas are reassociation-level).  8 virtual
CPU devices (tests/conftest.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

import parallel_gps_tpu as pgt
from parallel_gps_tpu.inference import fit_adam
from parallel_gps_tpu.inference.optim import make_loss
from parallel_gps_tpu.parallel.sharded import make_time_mesh
from parallel_gps_tpu.toymodels import obs_noise, sinu


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    t = np.sort(rng.rand(777))  # deliberately not divisible by 8
    y = obs_noise(sinu(t), 0.1, 1)
    y[rng.choice(777, 70, replace=False)] = np.nan
    return t, y


@pytest.fixture(scope="module")
def mesh():
    return make_time_mesh(8)


def _models(data, mesh, kernel=None):
    t, y = data
    kernel = kernel or pgt.kernels.Matern32(1.3, 0.33)
    single = pgt.StateSpaceGP.create((t, y), kernel, 0.12, parallel=True)
    sharded = pgt.StateSpaceGP.create(
        (t, y), kernel, 0.12, parallel=True, mesh=mesh
    )
    return single, sharded


def test_model_lml_sharded_matches_single(data, mesh):
    single, sharded = _models(data, mesh)
    l0 = float(single.log_marginal_likelihood())
    l1 = float(sharded.log_marginal_likelihood())
    assert abs(l0 - l1) / abs(l0) < 1e-12


def test_model_lml_grads_sharded_match(data, mesh):
    single, sharded = _models(data, mesh)
    loss_s, u0 = make_loss(single)
    loss_m, _ = make_loss(sharded)
    g_s = jax.grad(loss_s)(u0)
    g_m = jax.grad(loss_m)(u0)
    jax.tree.map(
        lambda a, b: npt.assert_allclose(a, b, rtol=1e-8, atol=1e-10),
        g_s,
        g_m,
    )


def test_model_predict_sharded_matches_single(data, mesh):
    single, sharded = _models(data, mesh)
    q = np.linspace(0.03, 0.97, 41)
    m0, v0 = single.predict_f(q)
    m1, v1 = sharded.predict_f(q)
    npt.assert_allclose(m1, m0, rtol=1e-9, atol=1e-11)
    npt.assert_allclose(v1, v0, rtol=1e-9, atol=1e-11)


def test_model_fit_adam_sharded(data, mesh):
    """End-to-end distributed training through the standard loop: fit_adam
    consumes the model's LML, so the meshed model trains on the sharded
    Fisher-VJP path with no loop changes."""
    single, sharded = _models(data, mesh)
    f_s, _ = fit_adam(single, n_iters=30, learning_rate=0.05)
    f_m, _ = fit_adam(sharded, n_iters=30, learning_rate=0.05)
    npt.assert_allclose(
        float(f_m.noise_variance), float(f_s.noise_variance), rtol=1e-7
    )
    assert float(f_m.log_marginal_likelihood()) > float(
        sharded.log_marginal_likelihood()
    )


def test_model_mcmc_sharded_matches_single(data, mesh):
    """A short HMC chain through the meshed model: run_one_mcmc consumes the
    model's LML/grads (sharded Fisher VJP), so sampling distributes with no
    driver changes.  Same seed + f64 + exact two-level
    combine => the sharded chain reproduces the single-device chain."""
    from parallel_gps_tpu.experiments.common import run_one_mcmc

    single, sharded = _models(data, mesh)
    s0, acc0, _ = run_one_mcmc(
        single, None, algo="hmc", n_samples=15, burnin=5,
        step_size=0.02, num_leapfrog_steps=5, seed=3,
    )
    s1, acc1, _ = run_one_mcmc(
        sharded, None, algo="hmc", n_samples=15, burnin=5,
        step_size=0.02, num_leapfrog_steps=5, seed=3,
    )
    assert 0.2 < acc1 <= 1.0
    npt.assert_allclose(acc1, acc0, rtol=1e-6)
    jax.tree.map(
        lambda a, b: npt.assert_allclose(a, b, rtol=1e-5, atol=1e-7), s1, s0
    )


def test_model_mesh_validation(data):
    t, y = data
    with pytest.raises(ValueError, match="parallel=True"):
        pgt.StateSpaceGP.create(
            (t, y), pgt.kernels.Matern32(), 0.1,
            parallel=False, mesh=make_time_mesh(8),
        )
    from jax.sharding import Mesh

    bad = Mesh(np.array(jax.devices()).reshape(8), ("batch",))
    with pytest.raises(ValueError, match="time"):
        pgt.StateSpaceGP.create(
            (t, y), pgt.kernels.Matern32(), 0.1, mesh=bad
        )
