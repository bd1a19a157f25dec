"""Multi-device tests on the 8-virtual-CPU mesh (SURVEY.md §4).

Pins the sharded two-level scan against the single-device engines, including
gradients through the shard_map'ed collectives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest

from parallel_gps_tpu.kalman.parallel import pkf, pkfs
from parallel_gps_tpu.kalman.sequential import kf
from parallel_gps_tpu.kernels import Matern32, Matern52
from parallel_gps_tpu.parallel import (
    make_time_mesh,
    sharded_pkf,
    sharded_pkfs,
)
from parallel_gps_tpu.toymodels import obs_noise, sinu


def _data(T=256, seed=0, with_nans=True):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = obs_noise(sinu(t), 0.1, seed)
    if with_nans:
        y[rng.choice(T, T // 6, replace=False)] = np.nan
    return jnp.asarray(t), jnp.asarray(y).reshape(-1, 1)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_time_mesh()


def test_sharded_filter_matches_single_device(mesh):
    t, y = _data()
    kernel = Matern32(variance=1.0, lengthscales=0.5)
    ssm = kernel.get_ssm(t.reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1))

    fms_1, fPs_1, ell_1 = pkf(ssm, y, return_loglikelihood=True)
    fms_8, fPs_8, ell_8 = jax.jit(
        lambda s, o: sharded_pkf(s, o, mesh, return_loglikelihood=True)
    )(ssm, y)

    npt.assert_allclose(fms_1, fms_8, atol=1e-10)
    npt.assert_allclose(fPs_1, fPs_8, atol=1e-10)
    npt.assert_allclose(ell_1, ell_8, atol=1e-10)


def test_sharded_smoother_matches_single_device(mesh):
    t, y = _data(T=512, seed=3)
    kernel = Matern52(variance=0.8, lengthscales=0.4)
    ssm = kernel.get_ssm(t.reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1))

    sms_1, sPs_1 = pkfs(ssm, y)
    sms_8, sPs_8 = jax.jit(lambda s, o: sharded_pkfs(s, o, mesh))(ssm, y)

    npt.assert_allclose(sms_1, sms_8, atol=1e-9)
    npt.assert_allclose(sPs_1, sPs_8, atol=1e-9)


def test_sharded_lml_gradients_match(mesh):
    """Gradients of the LML w.r.t. hyperparameters must flow through the
    shard_map'ed collectives and match the single-device value."""
    t, y = _data(T=128, seed=7, with_nans=False)
    R = jnp.asarray(0.1).reshape(1, 1)

    def lml_single(log_ell):
        k = Matern32(variance=1.0, lengthscales=jnp.exp(log_ell))
        ssm = k.get_ssm(t.reshape(-1, 1), R)
        return kf(ssm, y, return_loglikelihood=True)[2]

    def lml_sharded(log_ell):
        k = Matern32(variance=1.0, lengthscales=jnp.exp(log_ell))
        ssm = k.get_ssm(t.reshape(-1, 1), R)
        return sharded_pkf(ssm, y, mesh, return_loglikelihood=True)[2]

    g1 = jax.grad(lml_single)(jnp.asarray(-0.7))
    g8 = jax.jit(jax.grad(lml_sharded))(jnp.asarray(-0.7))
    npt.assert_allclose(g1, g8, rtol=1e-8)


def test_batched_gps_vmap_over_mesh(mesh):
    """64 independent GPs vmapped over the sharded filter (BASELINE.json
    config 5 batch mode, scaled down)."""
    t, _ = _data(T=64, with_nans=False)
    rng = np.random.RandomState(11)
    ys = jnp.asarray(
        np.tile(sinu(np.asarray(t)), (16, 1))
        + np.sqrt(0.1) * rng.randn(16, 64)
    )[..., None]
    kernel = Matern32(variance=1.0, lengthscales=0.5)
    ssm = kernel.get_ssm(t.reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1))

    ells_batched = jax.vmap(
        lambda y: pkf(ssm, y, return_loglikelihood=True)[2]
    )(ys)
    ells_seq = jnp.stack(
        [kf(ssm, ys[i], return_loglikelihood=True)[2] for i in range(4)]
    )
    npt.assert_allclose(ells_batched[:4], ells_seq, atol=1e-9)


# --------------------------------------------------------------------------
# Time-last (LGSSMTL) sharded engines
# --------------------------------------------------------------------------

from parallel_gps_tpu.kalman.timelast import (  # noqa: E402
    pkf_from_tl,
    pks_from_tl,
)
from parallel_gps_tpu.parallel.sharded import (  # noqa: E402
    sharded_pkf_tl,
    sharded_pkfs_tl,
)


def _tl_setup(T=512, seed=0):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = obs_noise(sinu(t), 0.1, seed + 1)
    y[rng.choice(T, T // 12, replace=False)] = np.nan
    ssm = Matern32(1.2, 0.4).get_ssm_tl(
        jnp.asarray(t).reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1)
    )
    return ssm, jnp.asarray(y).reshape(-1, 1), jnp.asarray(t).reshape(-1, 1)


def test_sharded_tl_filter_matches_single_device():
    mesh = make_time_mesh()
    ssm, ys, _ = _tl_setup()
    b1, C1, ell1 = pkf_from_tl(ssm, ys, True)
    b2, C2, ell2 = jax.jit(
        lambda s, o: sharded_pkf_tl(s, o, mesh, return_loglikelihood=True)
    )(ssm, ys)
    npt.assert_allclose(b2, b1, rtol=1e-9, atol=1e-11)
    npt.assert_allclose(C2, C1, rtol=1e-9, atol=1e-11)
    npt.assert_allclose(float(ell2), float(ell1), rtol=1e-11)


def test_sharded_tl_smoother_matches_single_device():
    mesh = make_time_mesh()
    ssm, ys, _ = _tl_setup(seed=3)
    b1, C1 = pkf_from_tl(ssm, ys)
    g1, L1 = pks_from_tl(ssm, b1, C1)
    g2, L2 = jax.jit(lambda s, o: sharded_pkfs_tl(s, o, mesh))(ssm, ys)
    npt.assert_allclose(g2, g1, rtol=1e-8, atol=1e-10)
    npt.assert_allclose(L2, L1, rtol=1e-8, atol=1e-10)


def test_sharded_tl_filter_matches_single_device_d6():
    # d > 3 leg: the sharded combine runs the d-generic TL operator
    # (Schur-recursed inverses) — RBF order 6 over the 8-device mesh must
    # match the single-device engine exactly in f64 (pure reassociation;
    # pinned at 1e-9 rel).
    from parallel_gps_tpu.kernels import RBF

    mesh = make_time_mesh()
    T = 1024
    rng = np.random.RandomState(9)
    t = np.sort(rng.rand(T))
    y = obs_noise(sinu(t), 0.1, 10)
    y[rng.choice(T, T // 12, replace=False)] = np.nan
    ssm = RBF(
        variance=1.0, lengthscales=0.25, order=6, balancing_iter=5
    ).get_ssm_tl(jnp.asarray(t).reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1))
    ys = jnp.asarray(y).reshape(-1, 1)
    b1, C1, ell1 = pkf_from_tl(ssm, ys, True)
    b2, C2, ell2 = jax.jit(
        lambda s, o: sharded_pkf_tl(s, o, mesh, return_loglikelihood=True)
    )(ssm, ys)
    npt.assert_allclose(b2, b1, rtol=1e-7, atol=1e-9)
    npt.assert_allclose(C2, C1, rtol=1e-7, atol=1e-9)
    npt.assert_allclose(float(ell2), float(ell1), rtol=1e-11)


def test_sharded_tl_gradients_match_single_device():
    mesh = make_time_mesh()
    _, ys, ts = _tl_setup(seed=5)

    def lml_sharded(var):
        s = Matern32(var, 0.4).get_ssm_tl(ts, jnp.asarray(0.1).reshape(1, 1))
        return sharded_pkf_tl(s, ys, mesh, return_loglikelihood=True)[2]

    def lml_single(var):
        s = Matern32(var, 0.4).get_ssm_tl(ts, jnp.asarray(0.1).reshape(1, 1))
        return pkf_from_tl(s, ys, True)[2]

    gs = float(jax.grad(lml_sharded)(jnp.asarray(1.2)))
    gr = float(jax.grad(lml_single)(jnp.asarray(1.2)))
    npt.assert_allclose(gs, gr, rtol=1e-9)


# --------------------------------------------------------------------------
# Sharded filter + smoother and the sharded Fisher-VJP LML at awkward sizes.
# --------------------------------------------------------------------------

from parallel_gps_tpu.kalman.timelast import lml_tl  # noqa: E402
from parallel_gps_tpu.parallel.sharded import sharded_lml_tl  # noqa: E402


def test_sharded_pallas_engine_matches_single_device():
    """The time-last sharded engine (the only per-shard engine) on a fresh
    series: filter moments, LML and the smoothed moments must match the
    single-device engine (f64, NaNs included)."""
    mesh = make_time_mesh()
    ssm, ys, _ = _tl_setup(T=512, seed=21)
    b1, C1, ell1 = pkf_from_tl(ssm, ys, True)
    g1, L1 = pks_from_tl(ssm, b1, C1)
    b2, C2, ell2 = jax.jit(
        lambda s, o: sharded_pkf_tl(s, o, mesh, return_loglikelihood=True)
    )(ssm, ys)
    npt.assert_allclose(b2, b1, rtol=1e-9, atol=1e-11)
    npt.assert_allclose(C2, C1, rtol=1e-9, atol=1e-11)
    npt.assert_allclose(float(ell2), float(ell1), rtol=1e-11)
    g2, L2 = jax.jit(lambda s, o: sharded_pkfs_tl(s, o, mesh))(ssm, ys)
    npt.assert_allclose(g2, g1, rtol=1e-8, atol=1e-10)
    npt.assert_allclose(L2, L1, rtol=1e-8, atol=1e-10)


def test_sharded_pallas_engine_uneven_shard_padding():
    """T = 380 is not a multiple of the 8 shards: padding with exact no-op
    steps (distributed.pad_time_axis) must leave the smoothed moments at
    every real step equal to the single-device engine's."""
    from parallel_gps_tpu.parallel.distributed import pad_time_axis

    mesh = make_time_mesh()
    ssm, ys, _ = _tl_setup(T=380, seed=23)
    b1, C1 = pkf_from_tl(ssm, ys)
    g1, L1 = pks_from_tl(ssm, b1, C1)
    ssm_p, ys_p, T = pad_time_axis(ssm, ys, mesh.shape["time"])
    assert ys_p.shape[0] == 384 and T == 380
    g2, L2 = jax.jit(lambda s, o: sharded_pkfs_tl(s, o, mesh))(ssm_p, ys_p)
    npt.assert_allclose(g2[:, :T], g1, rtol=1e-8, atol=1e-10)
    npt.assert_allclose(L2[:, :, :T], L1, rtol=1e-8, atol=1e-10)


def test_sharded_lml_fisher_vjp_matches_single_device():
    """sharded_lml_tl: value and hyperparameter gradients (Fisher identity,
    one sharded smoother backward) vs the single-device lml_tl."""
    mesh = make_time_mesh()
    ssm, ys, _ = _tl_setup(T=512, seed=29)
    v_ref, g_ref = jax.value_and_grad(lambda s: lml_tl(s, ys))(ssm)
    v, g = jax.jit(
        jax.value_and_grad(lambda s: sharded_lml_tl(s, ys, mesh, "time"))
    )(ssm)
    npt.assert_allclose(float(v), float(v_ref), rtol=1e-12)
    for ga, gb in zip(jax.tree.leaves(g), jax.tree.leaves(g_ref)):
        npt.assert_allclose(ga, gb, rtol=1e-7, atol=1e-10)
