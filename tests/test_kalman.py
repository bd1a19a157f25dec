"""Engine-level tests: sequential vs parallel parity, NaN path, operator
associativity, and discretization cross-checks.

Extends the reference's test strategy (SURVEY.md §4) with the property tests
it lacks (associativity of the combine operators, explicit NaN-path checks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

from parallel_gps_tpu.kalman.parallel import (
    FilteringElement,
    filtering_operator,
    pkf,
    pkfs,
    pks,
    smoothing_operator,
    SmoothingElement,
)
from parallel_gps_tpu.kalman.sequential import kf, kfs
from parallel_gps_tpu.kernels import Matern32, Matern52
from parallel_gps_tpu.ops.disc import discretize, discretize_mfd
from parallel_gps_tpu.toymodels import obs_noise, sinu


def _make_data(T=200, seed=31415926, with_nans=False):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = obs_noise(sinu(t), 0.1, seed)
    if with_nans:
        idx = rng.choice(T, size=T // 5, replace=False)
        y[idx] = np.nan
    return jnp.asarray(t), jnp.asarray(y).reshape(-1, 1)


def _make_ssm(t, kernel=None):
    kernel = kernel or Matern32(variance=1.0, lengthscales=0.5)
    return kernel.get_ssm(t.reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1))


@pytest.mark.parametrize("with_nans", [False, True])
def test_sequential_vs_parallel_filter(with_nans):
    t, y = _make_data(with_nans=with_nans)
    ssm = _make_ssm(t)
    fms_s, fPs_s, ell_s = kf(ssm, y, return_loglikelihood=True)
    fms_p, fPs_p, ell_p = pkf(ssm, y, return_loglikelihood=True)
    npt.assert_allclose(fms_s, fms_p, atol=1e-8)
    npt.assert_allclose(fPs_s, fPs_p, atol=1e-8)
    npt.assert_allclose(ell_s, ell_p, atol=1e-8)


@pytest.mark.parametrize("with_nans", [False, True])
def test_sequential_vs_parallel_smoother(with_nans):
    t, y = _make_data(with_nans=with_nans)
    ssm = _make_ssm(t, Matern52(variance=1.0, lengthscales=0.5))
    sms_s, sPs_s = kfs(ssm, y)
    sms_p, sPs_p = pkfs(ssm, y)
    npt.assert_allclose(sms_s, sms_p, atol=1e-8)
    npt.assert_allclose(sPs_s, sPs_p, atol=1e-8)


def test_all_nan_observations_give_prior_filter():
    """With every observation missing, the filter must return the prior
    marginals (pure prediction) and zero log-likelihood."""
    t, y = _make_data(T=50)
    y = jnp.full_like(y, jnp.nan)
    ssm = _make_ssm(t)
    fms, fPs, ell = pkf(ssm, y, return_loglikelihood=True)
    npt.assert_allclose(ell, 0.0, atol=1e-12)
    npt.assert_allclose(fms, jnp.zeros_like(fms), atol=1e-12)
    # Stationary model started at P∞: prior marginals stay P∞.
    npt.assert_allclose(fPs, jnp.broadcast_to(ssm.P0, fPs.shape), atol=1e-8)


def _random_filtering_elements(rng, n, d):
    def spd():
        M = rng.randn(n, d, d)
        return jnp.asarray(M @ M.transpose(0, 2, 1) + 0.5 * np.eye(d))

    return FilteringElement(
        A=jnp.asarray(rng.randn(n, d, d)),
        b=jnp.asarray(rng.randn(n, d)),
        C=spd(),
        J=spd() * 0.1,
        eta=jnp.asarray(rng.randn(n, d)),
    )


def test_filtering_operator_associativity():
    rng = np.random.RandomState(0)
    e1, e2, e3 = (
        jax.tree.map(lambda x: x[i], _random_filtering_elements(rng, 3, 4))
        for i in range(3)
    )
    left = filtering_operator(filtering_operator(e1, e2), e3)
    right = filtering_operator(e1, filtering_operator(e2, e3))
    for a, b in zip(left, right):
        npt.assert_allclose(a, b, atol=1e-8)


def test_smoothing_operator_associativity():
    rng = np.random.RandomState(1)
    elems = SmoothingElement(
        E=jnp.asarray(rng.randn(3, 4, 4)),
        g=jnp.asarray(rng.randn(3, 4)),
        L=jnp.asarray(rng.randn(3, 4, 4)),
    )
    e1, e2, e3 = (jax.tree.map(lambda x: x[i], elems) for i in range(3))
    left = smoothing_operator(smoothing_operator(e1, e2), e3)
    right = smoothing_operator(e1, smoothing_operator(e2, e3))
    for a, b in zip(left, right):
        npt.assert_allclose(a, b, atol=1e-10)


@pytest.mark.parametrize(
    "kernel",
    [
        Matern32(variance=2.0, lengthscales=0.3),
        Matern52(variance=0.7, lengthscales=1.2),
    ],
)
def test_discretize_matches_matrix_fraction(kernel):
    """The stationary-identity discretization (Q_k = P∞ − A P∞ Aᵀ) must agree
    with the reference's matrix-fraction path (pssgp/kernels/base.py:36-46)."""
    t = jnp.sort(jnp.asarray(np.random.RandomState(2).rand(64)))
    sde = kernel.get_sde()
    R = jnp.asarray(0.1).reshape(1, 1)
    a = discretize(sde, t.reshape(-1, 1), R)
    b = discretize_mfd(sde, t.reshape(-1, 1), R)
    npt.assert_allclose(a.Fs, b.Fs, atol=1e-9)
    npt.assert_allclose(a.Qs, b.Qs, atol=1e-9)


def test_parallel_smoother_reverse_equals_explicit_flip():
    """pks uses associative_scan(reverse=True); check against an explicit
    flip-scan-flip (the reference's formulation, parallel.py:191-196)."""
    t, y = _make_data(T=100)
    ssm = _make_ssm(t)
    fms, fPs = pkf(ssm, y)

    from parallel_gps_tpu.kalman.parallel import make_smoothing_elements

    elems = make_smoothing_elements(ssm, fms, fPs)
    flipped = jax.tree.map(lambda x: jnp.flip(x, axis=0), elems)
    scanned = jax.lax.associative_scan(smoothing_operator, flipped, axis=0)
    sms_ref = jnp.flip(scanned.g, axis=0)
    sPs_ref = jnp.flip(scanned.L, axis=0)

    sms, sPs = pks(ssm, fms, fPs)
    npt.assert_allclose(sms, sms_ref, atol=1e-12)
    npt.assert_allclose(sPs, sPs_ref, atol=1e-12)


def test_multi_chain_mcmc_recovers_gaussian():
    """sample_chains: 4 vmapped HMC chains on a correlated 2-D Gaussian
    recover its moments; chains are distinct."""
    import jax
    import jax.numpy as jnp

    from parallel_gps_tpu.inference.mcmc import hmc_kernel, sample_chains

    cov = jnp.asarray([[1.0, 0.6], [0.6, 2.0]])
    prec = jnp.linalg.inv(cov)

    def log_prob(tree):
        x = tree["x"]
        return -0.5 * x @ prec @ x

    kernel = hmc_kernel(
        lambda x: -0.5 * x @ prec @ x, step_size=0.4, num_leapfrog_steps=8
    )
    init = {"x": jnp.asarray(np.random.RandomState(0).randn(4, 2))}
    samples, accepted = sample_chains(
        kernel, init, log_prob, jax.random.PRNGKey(0), 1500, 300
    )
    xs = np.asarray(samples["x"])  # (4, 1500, 2)
    assert xs.shape == (4, 1500, 2)
    assert float(np.mean(np.asarray(accepted))) > 0.6
    # chains are distinct trajectories
    assert not np.allclose(xs[0], xs[1])
    pooled = xs.reshape(-1, 2)
    npt.assert_allclose(pooled.mean(axis=0), [0.0, 0.0], atol=0.15)
    npt.assert_allclose(np.cov(pooled.T), np.asarray(cov), atol=0.3)


def test_sample_chains_chunked_matches_monolithic():
    """lax.map chunking (the >32-chain XLA-cliff workaround) must produce
    bitwise-identical chains to the monolithic vmap: the per-chain keys are
    identical, only the batching strategy differs."""
    import jax
    import jax.numpy as jnp

    from parallel_gps_tpu.inference.mcmc import hmc_kernel, sample_chains

    prec = jnp.linalg.inv(jnp.asarray([[1.0, 0.4], [0.4, 1.5]]))

    def log_prob(tree):
        x = tree["x"]
        return -0.5 * x @ prec @ x

    kernel = hmc_kernel(
        lambda x: -0.5 * x @ prec @ x, step_size=0.3, num_leapfrog_steps=5
    )
    init = {"x": jnp.asarray(np.random.RandomState(1).randn(6, 2))}
    rng = __import__("jax").random.PRNGKey(7)
    mono, acc_m = sample_chains(
        kernel, init, log_prob, rng, 40, 10, chunk_size=None
    )
    chunked, acc_c = sample_chains(
        kernel, init, log_prob, rng, 40, 10, chunk_size=3
    )
    npt.assert_array_equal(np.asarray(mono["x"]), np.asarray(chunked["x"]))
    npt.assert_array_equal(np.asarray(acc_m), np.asarray(acc_c))


def test_dual_averaging_nuts_recovers_gaussian():
    """Opt-in warmup: dual averaging must adapt the NUTS
    step size so the trajectory-mean Metropolis acceptance sits near the
    0.8 target, and the adapted sampler must recover a known correlated
    Gaussian's moments."""
    import jax
    import jax.numpy as jnp

    from parallel_gps_tpu.inference.mcmc import (
        dual_averaging_warmup,
        make_kernel,
        sample_chain,
    )

    cov = jnp.asarray([[1.0, 0.8], [0.8, 2.0]])
    prec = jnp.linalg.inv(cov)

    def log_prob(tree):
        x = tree["x"]
        return -0.5 * x @ prec @ x

    def log_prob_flat(x):
        return -0.5 * x @ prec @ x

    init = {"x": jnp.asarray([3.0, -3.0])}  # far off, warmup must travel
    eps, warm = dual_averaging_warmup(
        lambda e: make_kernel("nuts", log_prob_flat, e),
        init,
        log_prob,
        jax.random.PRNGKey(1),
        num_warmup=300,
        target_accept=0.8,
    )
    eps = float(eps)
    assert 0.05 < eps < 5.0, eps
    kernel = make_kernel("nuts", log_prob_flat, eps)
    samples, accept = sample_chain(
        kernel, warm, log_prob, jax.random.PRNGKey(2), 1500, 100
    )
    mean_acc = float(np.mean(np.asarray(accept)))
    # acceptance statistic is a probability; adaptation targets 0.8
    assert 0.6 < mean_acc <= 1.0, mean_acc
    xs = np.asarray(samples["x"])
    npt.assert_allclose(xs.mean(axis=0), [0.0, 0.0], atol=0.25)
    npt.assert_allclose(np.cov(xs.T), np.asarray(cov), atol=0.45)


def test_sample_chains_pads_non_divisible_chain_counts():
    """48 chains with chunk_size=32 must still chunk (pad + discard), not
    fall back to a monolithic vmap(48) on the XLA fusion cliff; results for
    real chains are bitwise-identical to the unchunked run."""
    import jax
    import jax.numpy as jnp

    from parallel_gps_tpu.inference.mcmc import hmc_kernel, sample_chains

    def log_prob(tree):
        return -0.5 * jnp.sum(tree["x"] ** 2)

    kernel = hmc_kernel(
        lambda x: -0.5 * jnp.sum(x**2), step_size=0.5, num_leapfrog_steps=4
    )
    init = {"x": jnp.asarray(np.random.RandomState(3).randn(12, 2))}
    mono, acc_m = sample_chains(
        kernel, init, log_prob, jax.random.PRNGKey(5), 50, 10, chunk_size=None
    )
    chunked, acc_c = sample_chains(
        kernel, init, log_prob, jax.random.PRNGKey(5), 50, 10, chunk_size=5
    )
    assert chunked["x"].shape == (12, 50, 2)
    npt.assert_array_equal(np.asarray(mono["x"]), np.asarray(chunked["x"]))
    npt.assert_array_equal(np.asarray(acc_m), np.asarray(acc_c))
