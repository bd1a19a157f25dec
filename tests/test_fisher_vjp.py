"""Fisher-identity custom VJP (kalman.timelast.lml_tl) == end-to-end
autodiff of the XLA time-last engine.

The VJP computes ∇ℓ from smoothed moments in closed form (one smoother pass)
using the cancellation-free predicted-covariance forms; these tests pin it
against reverse-mode autodiff through the associative scan — values,
hyperparameter gradients (through discretization), and observation
gradients, with and without missing data.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

from parallel_gps_tpu.kalman.timelast import lml_tl, pkf_from_tl
from parallel_gps_tpu.kernels import Matern12, Matern32, Matern52
from parallel_gps_tpu.toymodels import obs_noise, sinu


def _data(T=157, nan_frac=0.1, seed=0):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = obs_noise(sinu(t), 0.1, seed + 1)
    if nan_frac:
        y[rng.choice(T, int(T * nan_frac), replace=False)] = np.nan
    return (
        jnp.asarray(t).reshape(-1, 1),
        jnp.asarray(y).reshape(-1, 1),
    )


@pytest.mark.parametrize(
    "Kcls", [Matern12, Matern32, Matern52], ids=["m12", "m32", "m52"]
)
@pytest.mark.parametrize("nan_frac", [0.0, 0.15], ids=["dense", "missing"])
def test_fisher_vjp_matches_autodiff(Kcls, nan_frac):
    ts, ys = _data(nan_frac=nan_frac, seed=3)

    def f_fisher(params, o):
        var, ell, nv = params
        ssm = Kcls(variance=var, lengthscales=ell).get_ssm_tl(
            ts, jnp.reshape(nv, (1, 1))
        )
        return lml_tl(ssm, o)

    def f_auto(params, o):
        var, ell, nv = params
        ssm = Kcls(variance=var, lengthscales=ell).get_ssm_tl(
            ts, jnp.reshape(nv, (1, 1))
        )
        return pkf_from_tl(ssm, o, True)[2]

    p = (jnp.asarray(1.3), jnp.asarray(0.4), jnp.asarray(0.07))
    v1, g1 = jax.value_and_grad(f_fisher, argnums=(0,))(p, ys)
    v2, g2 = jax.value_and_grad(f_auto, argnums=(0,))(p, ys)
    npt.assert_allclose(float(v1), float(v2), rtol=1e-12)
    npt.assert_allclose(
        np.asarray(jax.tree.leaves(g1)),
        np.asarray(jax.tree.leaves(g2)),
        rtol=1e-8,
        atol=1e-10,
    )
    gy1 = jax.grad(lambda o: f_fisher(p, o))(ys)
    gy2 = jax.grad(lambda o: f_auto(p, o))(ys)
    npt.assert_allclose(np.asarray(gy1), np.asarray(gy2), rtol=1e-8, atol=1e-11)


def test_fisher_vjp_matches_autodiff_d6():
    # d > 3 leg: the VJP's smoother gains / predicted-covariance inverses go
    # through the Schur-recursed _inv (timelast.py) — RBF order 6 exercises
    # it end-to-end through discretization gradients.
    from parallel_gps_tpu.kernels import RBF

    ts, ys = _data(T=97, nan_frac=0.1, seed=3)

    def make(params):
        var, ell, nv = params
        return RBF(
            variance=var, lengthscales=ell, order=6, balancing_iter=5
        ).get_ssm_tl(ts, jnp.reshape(nv, (1, 1)))

    def f_fisher(params, o):
        return lml_tl(make(params), o)

    def f_auto(params, o):
        return pkf_from_tl(make(params), o, True)[2]

    p = (jnp.asarray(1.1), jnp.asarray(0.3), jnp.asarray(0.07))
    v1, g1 = jax.value_and_grad(f_fisher, argnums=(0,))(p, ys)
    v2, g2 = jax.value_and_grad(f_auto, argnums=(0,))(p, ys)
    npt.assert_allclose(float(v1), float(v2), rtol=1e-12)
    npt.assert_allclose(
        np.asarray(jax.tree.leaves(g1)),
        np.asarray(jax.tree.leaves(g2)),
        rtol=1e-7,
        atol=1e-9,
    )


def test_fisher_vjp_small_dt_conditioning():
    # Tight time spacing makes Q nearly singular; the naive Fisher forms
    # (½(Q⁻¹MQ⁻¹ − Q⁻¹)) lose ~9 digits here — the predicted-covariance
    # forms must stay at autodiff-level accuracy.
    rng = np.random.RandomState(1)
    T = 200
    t = np.sort(rng.rand(T)) * 1e-3  # dt ~ 5e-6
    y = 0.1 * rng.randn(T)
    ts = jnp.asarray(t).reshape(-1, 1)
    ys = jnp.asarray(y).reshape(-1, 1)

    def f(params, use_fisher):
        var, ell = params
        ssm = Matern32(variance=var, lengthscales=ell).get_ssm_tl(
            ts, jnp.asarray(0.05).reshape(1, 1)
        )
        if use_fisher:
            return lml_tl(ssm, ys)
        return pkf_from_tl(ssm, ys, True)[2]

    p = (jnp.asarray(1.0), jnp.asarray(0.3))
    gf = jax.grad(lambda q: f(q, True))(p)
    ga = jax.grad(lambda q: f(q, False))(p)
    npt.assert_allclose(
        np.asarray(jax.tree.leaves(gf)),
        np.asarray(jax.tree.leaves(ga)),
        rtol=1e-7,
    )


def test_model_lml_gradient_uses_fisher_and_matches_generic():
    # StateSpaceGP routes parallel d<=3 through lml_tl; its hyperparameter
    # gradient must equal the generic-engine autodiff gradient.
    import parallel_gps_tpu as pgt

    ts, ys = _data(T=97, nan_frac=0.1, seed=5)

    def by_model(var):
        m = pgt.StateSpaceGP.create(
            (ts, ys), Matern32(variance=var, lengthscales=0.4), 0.07,
            parallel=True,
        )
        return m.log_marginal_likelihood()

    def by_generic(var):
        from parallel_gps_tpu.kalman.parallel import pkf

        ssm = Matern32(variance=var, lengthscales=0.4).get_ssm(
            ts, jnp.asarray(0.07).reshape(1, 1)
        )
        return pkf(ssm, ys, True, engine="generic")[2]

    v = jnp.asarray(1.3)
    npt.assert_allclose(float(by_model(v)), float(by_generic(v)), rtol=1e-10)
    npt.assert_allclose(
        float(jax.grad(by_model)(v)), float(jax.grad(by_generic)(v)), rtol=1e-8
    )


def _composite_makers():
    from parallel_gps_tpu.kernels import RBF, Periodic

    return {
        "sum_m32_m12": lambda p: Matern32(p[0], p[1]) + Matern12(p[2], p[3]),
        "prod_m32_m12": lambda p: Matern32(p[0], p[1]) * Matern12(p[2], p[3]),
        "rbf3": lambda p: RBF(p[0], p[1], order=3),
        "periodic2": lambda p: Periodic(p[0], p[1], period=0.7, order=2),
        "co2_shape": lambda p: (
            Periodic(1.0, p[1], period=0.5, order=1) * Matern32(p[0], 0.8)
            + Matern32(p[2], p[3])
        ),
    }


@pytest.mark.parametrize("name", list(_composite_makers()))
def test_fisher_vjp_composites_match_autodiff(name):
    """Fisher-identity gradients through Sum/Product/RBF/Periodic
    discretizations (balancing similarity included) vs reverse-mode
    autodiff of the time-last filter, f64."""
    make = _composite_makers()[name]
    ts, ys = _data(T=113, nan_frac=0.1, seed=4)

    def f(p, fisher):
        ssm = make(p).get_ssm_tl(ts, jnp.reshape(p[4], (1, 1)))
        return lml_tl(ssm, ys) if fisher else pkf_from_tl(ssm, ys, True)[2]

    p = jnp.asarray([1.1, 0.45, 0.9, 0.35, 0.1])
    v1, g1 = jax.value_and_grad(lambda q: f(q, True))(p)
    v2, g2 = jax.value_and_grad(lambda q: f(q, False))(p)
    npt.assert_allclose(float(v1), float(v2), rtol=1e-11)
    npt.assert_allclose(g1, g2, rtol=1e-7, atol=1e-9)


def test_fisher_vjp_vmapped_matches_loop():
    """vmap(value_and_grad(lml_tl)) over a batch of hyperparameters — the
    batched-chains shape — equals a Python loop of single evaluations."""
    ts, ys = _data(T=149, nan_frac=0.1, seed=8)

    def f(p):
        ssm = Matern32(p[0], p[1]).get_ssm_tl(ts, jnp.reshape(p[2], (1, 1)))
        return lml_tl(ssm, ys)

    ps = jnp.asarray([[1.1, 0.5, 0.1], [0.7, 0.9, 0.2], [1.4, 0.3, 0.05]])
    vs, gs = jax.vmap(jax.value_and_grad(f))(ps)
    for i in range(ps.shape[0]):
        v, g = jax.value_and_grad(f)(ps[i])
        npt.assert_allclose(float(vs[i]), float(v), rtol=1e-12)
        npt.assert_allclose(gs[i], g, rtol=1e-10, atol=1e-12)
