"""m > 1 observation support in the sequential and generic parallel engines.

The reference's element algebra is written with general (m, m) solves
(pssgp/kalman/parallel.py:26-33,104-110) although every experiment runs
m = 1; these tests pin the lifted implementation against an independent
textbook Kalman filter/smoother written in plain numpy (float64).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from parallel_gps_tpu.kalman.parallel import pkf, pkfs
from parallel_gps_tpu.kalman.sequential import kf, kfs
from parallel_gps_tpu.types import LGSSM


def _numpy_kfs(P0, Fs, Qs, H, R, ys):
    """Textbook KF + RTS smoother, m-dim observations, NaN = missing step."""
    T, d = Fs.shape[0], P0.shape[0]
    m = np.zeros(d)
    P = P0.copy()
    fms, fPs, mps, Pps = [], [], [], []
    ell = 0.0
    for t in range(T):
        mp = Fs[t] @ m
        Pp = Fs[t] @ P @ Fs[t].T + Qs[t]
        Pp = 0.5 * (Pp + Pp.T)
        mps.append(mp)
        Pps.append(Pp)
        y = ys[t]
        if not np.any(np.isnan(y)):
            S = H @ Pp @ H.T + R
            K = Pp @ H.T @ np.linalg.inv(S)
            diff = y - H @ mp
            m = mp + K @ diff
            P = Pp - K @ S @ K.T
            P = 0.5 * (P + P.T)
            sign, logdet = np.linalg.slogdet(S)
            ell += -0.5 * (
                diff @ np.linalg.solve(S, diff)
                + logdet
                + len(y) * np.log(2 * np.pi)
            )
        else:
            m, P = mp, Pp
        fms.append(m)
        fPs.append(P)
    fms, fPs = np.stack(fms), np.stack(fPs)
    sms, sPs = [fms[-1]], [fPs[-1]]
    for t in range(T - 2, -1, -1):
        C = fPs[t] @ Fs[t + 1].T @ np.linalg.inv(Pps[t + 1])
        sm = fms[t] + C @ (sms[0] - mps[t + 1])
        sP = fPs[t] + C @ (sPs[0] - Pps[t + 1]) @ C.T
        sms.insert(0, sm)
        sPs.insert(0, 0.5 * (sP + sP.T))
    return fms, fPs, float(ell), np.stack(sms), np.stack(sPs)


@pytest.fixture(scope="module")
def m2_problem():
    """A d=3, m=2 LGSSM: two noisy linear readouts of a stable random SSM.

    P0 is the STATIONARY covariance (discrete Lyapunov solution): the
    parallel engine's first element updates against (m0, P0) directly
    (reference pssgp/kalman/parallel.py:13-43) while the sequential engine
    predicts through (F0, Q0) first — the two conventions coincide exactly
    iff F P0 Fᵀ + Q = P0, which holds for every compiler-emitted SSM by
    construction (ops/disc.py: Q = P0 − A P0 Aᵀ)."""
    from scipy.linalg import solve_discrete_lyapunov

    rng = np.random.RandomState(7)
    d, m, T = 3, 2, 61
    A = rng.randn(d, d)
    A = 0.9 * A / np.abs(np.linalg.eigvals(A)).max()
    Fs = np.broadcast_to(A, (T, d, d)).copy()
    Qw = rng.randn(d, d)
    Q = 0.3 * Qw @ Qw.T + 0.1 * np.eye(d)
    Qs = np.broadcast_to(Q, (T, d, d)).copy()
    P0 = solve_discrete_lyapunov(A, Q)
    H = rng.randn(m, d)
    Rw = rng.randn(m, m)
    R = 0.2 * Rw @ Rw.T + 0.05 * np.eye(m)
    ys = rng.randn(T, m)
    ys[5] = np.nan  # fully missing step
    ys[17] = np.nan
    return P0, Fs, Qs, H, R, ys


def _as_lgssm(P0, Fs, Qs, H, R):
    return LGSSM(
        jnp.asarray(P0), jnp.asarray(Fs), jnp.asarray(Qs),
        jnp.asarray(H), jnp.asarray(R),
    )


def test_sequential_m2_vs_numpy(m2_problem):
    P0, Fs, Qs, H, R, ys = m2_problem
    fms_np, fPs_np, ell_np, sms_np, sPs_np = _numpy_kfs(P0, Fs, Qs, H, R, ys)
    lg = _as_lgssm(P0, Fs, Qs, H, R)
    fms, fPs, ell = kf(lg, jnp.asarray(ys), return_loglikelihood=True)
    np.testing.assert_allclose(fms, fms_np, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(fPs, fPs_np, rtol=1e-9, atol=1e-10)
    assert abs(float(ell) - ell_np) < 1e-8
    sms, sPs = kfs(lg, jnp.asarray(ys))
    np.testing.assert_allclose(sms, sms_np, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(sPs, sPs_np, rtol=1e-8, atol=1e-9)


def test_generic_parallel_m2_vs_numpy(m2_problem):
    P0, Fs, Qs, H, R, ys = m2_problem
    fms_np, fPs_np, ell_np, sms_np, sPs_np = _numpy_kfs(P0, Fs, Qs, H, R, ys)
    lg = _as_lgssm(P0, Fs, Qs, H, R)
    fms, fPs, ell = pkf(
        lg, jnp.asarray(ys), return_loglikelihood=True, engine="generic"
    )
    np.testing.assert_allclose(fms, fms_np, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(fPs, fPs_np, rtol=1e-8, atol=1e-9)
    assert abs(float(ell) - ell_np) < 1e-7
    sms, sPs = pkfs(lg, jnp.asarray(ys), engine="generic")
    np.testing.assert_allclose(sms, sms_np, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(sPs, sPs_np, rtol=1e-7, atol=1e-8)


def test_m2_auto_routes_to_generic(m2_problem):
    """engine='auto' must not send m>1 into the scalar-specialized TL path."""
    P0, Fs, Qs, H, R, ys = m2_problem
    lg = _as_lgssm(P0, Fs, Qs, H, R)
    fms, fPs, ell = pkf(lg, jnp.asarray(ys), return_loglikelihood=True)
    _, _, ell_np, _, _ = _numpy_kfs(P0, Fs, Qs, H, R, ys)
    assert abs(float(ell) - ell_np) < 1e-7


def test_m2_explicit_fast_engines_raise(m2_problem):
    P0, Fs, Qs, H, R, ys = m2_problem
    lg = _as_lgssm(P0, Fs, Qs, H, R)
    with pytest.raises(ValueError, match="scalar observations"):
        pkf(lg, jnp.asarray(ys), engine="timelast")
    with pytest.raises(ValueError, match="engine must be one of"):
        pkf(lg, jnp.asarray(ys), engine="pallas")
