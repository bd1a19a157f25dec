"""Golden-value tests of the kernel → SDE compilers.

Pins exact numbers for the RBF and Periodic SDE coefficients, following the
reference's golden tests (tests/test_rbf.py:26-57, tests/test_periodic.py:29-61).
The expected matrices are mathematical constants of the order-3 RBF / order-2
periodic derivations (originally from the paper's MATLAB derivation) — they
characterize behavior, independent of implementation.
"""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

from parallel_gps_tpu.kernels import RBF, Periodic, Matern12, Matern32
from parallel_gps_tpu.kernels.periodic import _offline_coeffs


def test_rbf_sde_coefficients():
    cov = RBF(variance=1.0, lengthscales=0.1, order=3, balancing_iter=5)
    Pinf, F, L, H, Q = cov.get_sde()

    F_expected = np.array(
        [
            [0, 14.520676967550859, 0],
            [0, 0, 32.857489440296360],
            [-14.5210953665873, -29.4746060478111, -50.3678777987092],
        ]
    )
    L_expected = np.array([0.0, 0.0, 1.0]).reshape(3, 1)
    H_expected = np.array([1.0, 0.0, 0.0]).reshape(1, 3)
    Q_expected = 52.8553179255264
    Pinf_expected = np.array(
        [
            [1.04502531824891, 0.0, -0.301281550265743],
            [0.0, 0.681741999944955, 0.0],
            [-0.301281550265743, 0.0, 0.611552410634913],
        ]
    )

    npt.assert_array_almost_equal(F, F_expected, decimal=8)
    npt.assert_array_almost_equal(L, L_expected, decimal=8)
    npt.assert_array_almost_equal(H, H_expected, decimal=8)
    npt.assert_array_almost_equal(np.squeeze(Q), Q_expected, decimal=8)
    npt.assert_array_almost_equal(Pinf, Pinf_expected, decimal=8)


def test_rbf_balancing_convergence():
    """More balancing iterations must not change the model materially
    (reference: tests/test_rbf.py:49-57)."""
    a = RBF(variance=1.0, lengthscales=0.1, order=3, balancing_iter=5).get_sde()
    b = RBF(variance=1.0, lengthscales=0.1, order=3, balancing_iter=15).get_sde()
    for x, y in zip(a, b):
        npt.assert_array_almost_equal(x, y, decimal=3)


def test_periodic_offline_coeffs():
    b, K, div_facto_K = _offline_coeffs(2)
    npt.assert_almost_equal(
        b, np.array([[1, 0, 0], [0, 2, 0], [2, 0, 2]]), decimal=8
    )
    npt.assert_almost_equal(
        K, np.array([[0, 0, 0], [1, 1, 1], [2, 2, 2]]), decimal=8
    )
    npt.assert_almost_equal(
        div_facto_K,
        np.array([[1, 1, 1], [1, 1, 1], [0.5, 0.5, 0.5]]),
        decimal=8,
    )


def test_periodic_sde_coefficients():
    cov = Periodic(variance=1.0, lengthscales=0.1, period=1.0, order=2)
    Pinf, F, L, H, Q = cov.get_sde()

    F_expected = np.zeros((6, 6))
    F_expected[2, 3] = -6.283185307179586
    F_expected[4, 5] = -12.5663706143592
    F_expected = F_expected - F_expected.T

    npt.assert_almost_equal(F, F_expected)
    npt.assert_almost_equal(L, np.eye(6))
    npt.assert_almost_equal(H, np.array([[1, 0, 1, 0, 1, 0]]))
    npt.assert_almost_equal(Q, np.zeros((6, 6)))
    Pinf_expected = np.diag(
        [
            1.20739740482544e-19,
            1.20739740482544e-19,
            9.64374923981979e-21,
            9.64374923981979e-21,
            1.20546865497747e-19,
            1.20546865497747e-19,
        ]
    )
    npt.assert_almost_equal(Pinf, Pinf_expected)


def test_matern_stationary_variance_is_kernel_variance():
    """k(0) == σ² must hold for the SDE's H P∞ Hᵀ."""
    for cov in [
        Matern12(variance=2.0, lengthscales=0.7),
        Matern32(variance=2.0, lengthscales=0.7),
    ]:
        sde = cov.get_sde()
        k0 = (sde.H @ sde.P0 @ sde.H.T)[0, 0]
        npt.assert_allclose(k0, 2.0, rtol=1e-10)


def test_dense_covariances_match_sde_stationary_covariance():
    """For each kernel, H expm(F τ) P∞ Hᵀ must reproduce k(τ) — the defining
    property of the SDE representation."""
    from jax.scipy.linalg import expm
    import jax

    taus = jnp.linspace(0.0, 2.0, 9)
    for cov, tol in [
        (Matern12(variance=1.3, lengthscales=0.6), 1e-9),
        (Matern32(variance=1.3, lengthscales=0.6), 1e-9),
        (Periodic(variance=1.1, lengthscales=0.9, period=0.7, order=10), 1e-6),
        (RBF(variance=1.3, lengthscales=0.6, order=9), 5e-3),
    ]:
        sde = cov.get_sde()
        k_sde = jax.vmap(
            lambda tau: (sde.H @ expm(tau * sde.F) @ sde.P0 @ sde.H.T)[0, 0]
        )(taus)
        k_dense = cov.dense(jnp.zeros((1,)), taus.reshape(-1, 1))[0]
        npt.assert_allclose(k_sde, k_dense, atol=tol, rtol=tol)


def test_composite_time_last_transitions_match_batched():
    """Periodic/Sum/Product build (d, d, T) transition planes directly
    (transitions_m1_tl); they must equal the batched closed forms exactly —
    composite discretization must never need the register-padded (T, d, d)
    layout (ops/expm.py::expm1_dt_tl rationale)."""
    from parallel_gps_tpu.kernels import Matern52

    rng = np.random.RandomState(0)
    dts = jnp.asarray(np.abs(rng.rand(64)) * 0.01 + 1e-5)
    ts = jnp.asarray(np.sort(rng.rand(64))).reshape(-1, 1)
    R = jnp.asarray(0.1).reshape(1, 1)
    for cov in [
        Periodic(1.2, 0.7, 1.3, order=3),
        Matern32(1.0, 0.5) + Matern52(0.8, 0.4),
        Periodic(1.0, 0.5, 1.0, order=2) * Matern32(1.0, 0.5),
        # the CO2 showcase composite, d = 18
        Periodic(1.0, 0.5, 1.0, order=3) * Matern32(1.0, 0.5)
        + Matern32(0.5, 2.0),
    ]:
        tl = cov.transitions_m1_tl(dts)
        assert tl is not None and tl.shape[-1] == dts.shape[0]
        bt = jnp.moveaxis(cov.transitions_m1(dts), 0, -1)
        npt.assert_array_equal(tl, bt)
        s_tl = cov.get_ssm_tl(ts, R)
        s_bt = cov.get_ssm(ts, R)
        npt.assert_array_equal(s_tl.Fs, jnp.moveaxis(s_bt.Fs, 0, -1))
        npt.assert_array_equal(s_tl.Qs, jnp.moveaxis(s_bt.Qs, 0, -1))


def test_rbf_spectral_transitions_match_pade():
    """RBF order ≤ 8 transitions via the trace-time spectral form
    (kernels/rbf.py::_rbf_spectral) == the Padé expm1 oracle at f64; beyond
    _SPECTRAL_MAX_ORDER the closed form is withheld (Padé path kept)."""
    from parallel_gps_tpu.ops.expm import expm1_dt_tl

    rng = np.random.RandomState(1)
    dts = jnp.asarray(
        np.concatenate([[1e-8, 1e-5, 1e-3], rng.rand(40) * 2.0])
    )
    for order in (3, 4, 6, 8):
        for ell in (0.3, 1.0, 2.7):
            k = RBF(1.3, ell, order=order)
            truth = expm1_dt_tl(k.get_sde().F, dts)
            spec = k.transitions_m1_tl(dts)
            scale = float(jnp.max(jnp.abs(truth)))
            npt.assert_allclose(
                spec, truth, atol=1e-9 * scale,
                err_msg=f"order={order} ell={ell}",
            )
            # batched variant consistent with the time-last one
            npt.assert_allclose(
                k.transitions_m1(dts), jnp.moveaxis(spec, -1, 0), rtol=1e-15
            )
    assert RBF(1.0, 1.0, order=12).transitions_m1_tl(dts) is None
    assert RBF(1.0, 1.0, order=12).transition_coeffs() is None


def test_rbf_transition_coeffs_match_transitions_m1_tl():
    """RBF build(c, dt) == transitions_m1_tl(dt) entrywise — the
    transition_coeffs contract (cf. the parametrized test below)."""
    dts = jnp.asarray(np.random.RandomState(0).rand(37) * 0.1)
    for order in (3, 6):
        kern = RBF(1.2, 0.55, order=order)
        coeffs, build = kern.transition_coeffs()
        rows = build(list(coeffs), dts)
        ref = kern.transitions_m1_tl(dts)
        for i in range(order):
            for j in range(order):
                npt.assert_allclose(
                    rows[i][j], ref[i, j], rtol=1e-11, atol=1e-13,
                    err_msg=f"order={order}[{i},{j}]",
                )


def _coeff_kernels():
    from parallel_gps_tpu.kernels import Matern52

    return [
        ("m12", Matern12(1.3, 0.7)),
        ("m32", Matern32(1.1, 0.5)),
        ("m52", Matern52(0.8, 0.4)),
        ("sum_m32_m12", Matern32(1.1, 0.5) + Matern12(0.8, 0.3)),
        ("prod_m32_m32", Matern32(1.2, 0.6) * Matern32(0.9, 0.4)),
        ("periodic2", Periodic(1.3, 0.8, period=0.7, order=2)),
        ("quasiperiodic",
         Periodic(1.0, 1.0, period=0.5, order=1) * Matern12(1.0, 0.7)),
        ("co2_shape",
         Periodic(1.0, 1.0, period=0.5, order=1) * Matern32(0.5, 0.8)
         + Matern32(1.0, 1.5)),
    ]


@pytest.mark.parametrize(
    "name,kern", _coeff_kernels(), ids=[n for n, _ in _coeff_kernels()]
)
def test_transition_coeffs_match_transitions_m1_tl(name, kern):
    """build(c, dt) == transitions_m1_tl(dt) entrywise, structural zeros
    (None) included — the elementwise closed form a fused discretization
    consumes must be the discretization the engines use."""
    dts = jnp.asarray(np.random.RandomState(0).rand(37) * 0.1)
    coeffs, build = kern.transition_coeffs()
    rows = build(list(coeffs), dts)
    ref = np.asarray(kern.transitions_m1_tl(dts))
    d = kern.state_dim
    assert len(rows) == d and all(len(r) == d for r in rows)
    for i in range(d):
        for j in range(d):
            got = 0.0 if rows[i][j] is None else rows[i][j]
            npt.assert_allclose(
                np.broadcast_to(got, ref[i, j].shape), ref[i, j],
                rtol=1e-11, atol=1e-13, err_msg=f"{name}[{i},{j}]",
            )
