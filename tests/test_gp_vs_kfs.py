"""Oracle-equivalence tests: StateSpaceGP (sequential & parallel) vs dense GP.

Port of the reference's load-bearing correctness story
(tests/test_gp_vs_kfs.py): same kernels, same data protocol (T=200 sorted
uniform times, noisy sinusoid), same per-kernel tolerances encoding expected
SDE-approximation error.  Checks (a) LML values, (b) gradients of LML w.r.t.
the unconstrained hyperparameters, (c) posterior mean/var at K=50 queries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

from parallel_gps_tpu.kernels import (
    Matern12,
    Matern32,
    Matern52,
    Periodic,
    RBF,
)
from parallel_gps_tpu.models import GPR, StateSpaceGP
from parallel_gps_tpu.models.params import constrain, unconstrain, as_arrays
from parallel_gps_tpu.toymodels import obs_noise, sinu

T = 200
K = 50
_rng = np.random.RandomState(31415926)
_t = np.sort(_rng.rand(T))
_y = obs_noise(sinu(_t), 0.1, 42)
_query = np.sort(_rng.rand(K))

DATA = (jnp.asarray(_t).reshape(-1, 1), jnp.asarray(_y).reshape(-1, 1))

COVS = [
    (Matern12(variance=1.0, lengthscales=0.5), 1e-6, 1e-2),
    (Matern32(variance=1.0, lengthscales=0.5), 1e-6, 1e-2),
    (Matern52(variance=1.0, lengthscales=0.5), 1e-6, 1e-2),
    (RBF(variance=1.0, lengthscales=0.5, order=15, balancing_iter=10), 1e-2, 1e-2),
    (Periodic(variance=1.0, lengthscales=0.5, period=0.5, order=10), 1e-3, 1e-3),
    (
        Matern32(variance=1.0, lengthscales=0.5)
        + Matern52(variance=1.0, lengthscales=0.5),
        1e-6,
        1e-2,
    ),
    (
        Matern32(variance=1.0, lengthscales=0.5)
        * Matern52(variance=1.0, lengthscales=0.5),
        1e-6,
        1e-1,
    ),
]

IDS = ["m12", "m32", "m52", "rbf15", "periodic10", "sum", "product"]


def _lml_and_grad(model_ctor, kernel):
    """LML and its gradient w.r.t. unconstrained (kernel, noise) params."""
    hypers = as_arrays(unconstrain({"kernel": kernel, "noise_variance": 0.1}))

    def loss(u):
        c = constrain(u)
        return model_ctor(c["kernel"], c["noise_variance"])

    val, grad = jax.value_and_grad(loss)(hypers)
    return val, grad


@pytest.mark.parametrize("cov,val_tol,grad_tol", COVS, ids=IDS)
def test_loglikelihood(cov, val_tol, grad_tol):
    def gp_lml(kernel, noise):
        return GPR(
            ts=DATA[0], ys=DATA[1], kernel=kernel, noise_variance=noise
        ).log_marginal_likelihood()

    gp_val, gp_grad = _lml_and_grad(gp_lml, cov)

    for parallel in [False, True]:

        def ss_lml(kernel, noise, parallel=parallel):
            return StateSpaceGP.create(
                DATA, kernel, noise, parallel=parallel
            ).log_marginal_likelihood()

        ss_val, ss_grad = _lml_and_grad(ss_lml, cov)
        npt.assert_allclose(gp_val, ss_val, atol=val_tol, rtol=val_tol)
        for g1, g2 in zip(
            jax.tree.leaves(gp_grad), jax.tree.leaves(ss_grad)
        ):
            npt.assert_allclose(g1, g2, atol=grad_tol, rtol=grad_tol)


# Posterior parity runs the parallel engine only: sequential≡parallel is
# pinned exactly in tests/test_kalman.py, so re-running every kernel through
# both engines here would only re-pay ~10 large XLA compiles for no extra
# coverage (this box is compile-bound, SURVEY.md §4 protocol kept otherwise).
@pytest.mark.parametrize("cov,val_tol,grad_tol", COVS, ids=IDS)
def test_posterior(cov, val_tol, grad_tol):
    del grad_tol
    gp = GPR(ts=DATA[0], ys=DATA[1], kernel=cov, noise_variance=jnp.asarray(0.1))
    mean_gp, var_gp = gp.predict_f(jnp.asarray(_query).reshape(-1, 1))
    ss = StateSpaceGP.create(DATA, cov, 0.1, parallel=True)
    mean_ss, var_ss = ss.predict_f(_query)
    npt.assert_allclose(mean_gp, mean_ss, atol=val_tol, rtol=val_tol)
    npt.assert_allclose(var_gp, var_ss, atol=val_tol, rtol=val_tol)


# The sequential model-level predict path (merge + NaN injection + reverse
# smoother) oracle-checked — the reference's both-engines loop
# (tests/test_gp_vs_kfs.py:88).  Simple kernels are represented by Matern32
# and Periodic (seq≡par is pinned exactly in test_kalman.py, so the
# remaining simple kernels add compile time but no coverage); the COMPOSITE
# kernels run both engines in full, as their sequential predict path
# (merge + reverse smoother at d = 5/6) has no other dense-oracle check.
@pytest.mark.parametrize(
    "idx",
    [1, 4, 5, 6],
    ids=[
        "m32-sequential",
        "periodic10-sequential",
        "sum-sequential",
        "product-sequential",
    ],
)
def test_posterior_sequential(idx):
    cov, val_tol, _ = COVS[idx]
    gp = GPR(ts=DATA[0], ys=DATA[1], kernel=cov, noise_variance=jnp.asarray(0.1))
    mean_gp, var_gp = gp.predict_f(jnp.asarray(_query).reshape(-1, 1))
    ss = StateSpaceGP.create(DATA, cov, 0.1, parallel=False)
    mean_ss, var_ss = ss.predict_f(_query)
    npt.assert_allclose(mean_gp, mean_ss, atol=val_tol, rtol=val_tol)
    npt.assert_allclose(var_gp, var_ss, atol=val_tol, rtol=val_tol)
