"""Time-last engine == sequential oracle over the (kernel, T) grid and the
composite kernels, in f64: filter moments and LML, smoothed moments, the
model-level LML and the time-last Schur-recursed inverse."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

import parallel_gps_tpu as pgt
from parallel_gps_tpu.kalman import kf, kfs
from parallel_gps_tpu.kalman.timelast import _inv, pkf_from_tl, pkfs_from_tl
from parallel_gps_tpu.kernels import RBF, Matern12, Matern32, Matern52, Periodic
from parallel_gps_tpu.toymodels import obs_noise, sinu


def _setup(kernel, T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = obs_noise(sinu(t), 0.1, seed)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    ts = jnp.asarray(t).reshape(-1, 1)
    ys = jnp.asarray(y).reshape(-1, 1)
    R = jnp.asarray(0.1).reshape(1, 1)
    return t, y, kernel.get_ssm_tl(ts, R), kernel.get_ssm(ts, R), ys


_GRID = [
    (Matern12(1.2, 0.6), 301),
    (Matern32(1.0, 0.5), 200),
    (Matern32(1.0, 0.5), 517),
    (Matern52(0.8, 0.4), 130),
    (Matern52(0.8, 0.4), 279),
    (RBF(1.0, 0.3, order=4, balancing_iter=5), 37),
]
_GRID_IDS = ["m12_T301", "m32_T200", "m32_T517", "m52_T130", "m52_T279",
             "rbf4_T37"]


def _composites():
    return [
        ("sum_m32_m12", Matern32(1.1, 0.5) + Matern12(0.8, 0.3)),
        ("prod_m32_m32", Matern32(1.2, 0.6) * Matern32(0.9, 0.4)),
        ("periodic2", Periodic(1.3, 0.8, period=0.7, order=2)),
        (
            "quasiperiodic",
            Periodic(1.0, 1.0, period=0.5, order=1) * Matern12(1.0, 0.7),
        ),
        (
            "co2_shape",
            Periodic(1.0, 1.0, period=0.5, order=1) * Matern32(0.5, 0.8)
            + Matern32(1.0, 1.5),
        ),
    ]


@pytest.mark.parametrize("kernel,T", _GRID, ids=_GRID_IDS)
def test_tl_filter_matches_sequential(kernel, T):
    _, _, ssm_tl, ssm, ys = _setup(kernel, T, seed=7)
    b, C, ell = pkf_from_tl(ssm_tl, ys, True)
    fms, fPs, ell_ref = kf(ssm, ys, return_loglikelihood=True)
    npt.assert_allclose(jnp.moveaxis(b, -1, 0), fms, rtol=1e-8, atol=1e-10)
    npt.assert_allclose(jnp.moveaxis(C, -1, 0), fPs, rtol=1e-8, atol=1e-10)
    npt.assert_allclose(float(ell), float(ell_ref), rtol=1e-10)


@pytest.mark.parametrize(
    "kernel,T,seed",
    [(Matern32(1.0, 0.5), 413, 11), (Matern32(1.0, 0.5), 150, 3),
     (Matern52(0.8, 0.4), 301, 13)],
    ids=["m32_T413", "m32_T150", "m52_T301"],
)
def test_tl_smoother_matches_sequential(kernel, T, seed):
    _, _, ssm_tl, ssm, ys = _setup(kernel, T, seed)
    sms, sPs = pkfs_from_tl(ssm_tl, ys)
    sms_ref, sPs_ref = kfs(ssm, ys)
    npt.assert_allclose(sms, sms_ref, rtol=1e-7, atol=1e-9)
    npt.assert_allclose(sPs, sPs_ref, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize(
    "name,kern", _composites(), ids=[n for n, _ in _composites()]
)
def test_composite_model_lml_matches_sequential(name, kern):
    """StateSpaceGP(parallel=True) — the time-last engine with the
    composite's Schur-recursed inverses — vs parallel=False (sequential)."""
    t, y, *_ = _setup(kern, 97, seed=13)
    par = pgt.StateSpaceGP.create((t, y), kern, 0.1, parallel=True)
    seq = pgt.StateSpaceGP.create((t, y), kern, 0.1, parallel=False)
    npt.assert_allclose(
        float(par.log_marginal_likelihood()),
        float(seq.log_marginal_likelihood()),
        rtol=1e-9,
    )
    xq = np.asarray([0.05, 0.5, 0.95])
    m_p, v_p = par.predict_f(xq)
    m_s, v_s = seq.predict_f(xq)
    npt.assert_allclose(m_p, m_s, rtol=1e-7, atol=1e-9)
    npt.assert_allclose(v_p, v_s, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("d", range(1, 9))
def test_tl_inverse_matches_numpy(d):
    """kalman.timelast._inv (adjugate for d <= 3, Schur recursion above) on
    (d, d, T) planes against numpy, on well-conditioned I + PSD matrices."""
    rng = np.random.RandomState(d)
    T = 5
    Ms = []
    for _ in range(T):
        A = rng.randn(d, d)
        Ms.append(np.eye(d) + 0.3 * (A @ A.T))
    M = np.stack(Ms, axis=-1)  # (d, d, T)
    got = np.asarray(_inv(jnp.asarray(M)))
    want = np.stack([np.linalg.inv(Ms[k]) for k in range(T)], axis=-1)
    npt.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_tl_engine_under_vmap_matches_loop():
    """vmap of the time-last LML over a batch of observation series (the
    batched-chains shape) equals a Python loop."""
    from parallel_gps_tpu.kalman.timelast import lml_tl

    kernel = Matern32(1.0, 0.4)
    _, _, ssm_tl, _, ys = _setup(kernel, 128, seed=2)
    batch = ys[None] + 0.1 * jnp.asarray(np.random.RandomState(0).randn(4, 128, 1))
    got = jax.vmap(lambda o: lml_tl(ssm_tl, o))(batch)
    want = [float(lml_tl(ssm_tl, batch[i])) for i in range(4)]
    npt.assert_allclose(got, want, rtol=1e-12)
