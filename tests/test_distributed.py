"""Multi-host plumbing (parallel/distributed.py) on the virtual 8-device
CPU mesh: T-padding exactness, batched TL sharded LML, the scan-efficiency
harness, and single-process initialize() no-op."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt

from parallel_gps_tpu.kalman.timelast import pkf_from_tl
from parallel_gps_tpu.kernels import Matern32
from parallel_gps_tpu.parallel.distributed import (
    initialize,
    make_process_mesh,
    pad_time_axis,
    scan_efficiency_report,
)
from parallel_gps_tpu.parallel.sharded import (
    make_time_mesh,
    sharded_batched_lml_tl,
    sharded_pkf_tl,
)


def _series(T, seed=0, dtype=jnp.float64):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T)) * 4.0
    y = np.sin(7 * t) + 0.1 * rng.randn(T)
    ts = jnp.asarray(t, dtype).reshape(-1, 1)
    ys = jnp.asarray(y, dtype).reshape(-1, 1)
    return ts, ys


def test_initialize_single_process_is_noop(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() == 1


def test_pad_time_axis_is_exact_noop():
    # Padded steps (F=I, Q=0, NaN obs) must leave moments at real steps and
    # the LML bitwise-unchanged.
    T, mult = 37, 16
    ts, ys = _series(T)
    kernel = Matern32(variance=1.3, lengthscales=0.4)
    R = jnp.asarray(0.1, ts.dtype).reshape(1, 1)
    ssm = kernel.get_ssm_tl(ts, R)

    ssm_p, ys_p, T_orig = pad_time_axis(ssm, ys, mult)
    assert T_orig == T and ssm_p.Fs.shape[-1] == 48
    b, C, ell = pkf_from_tl(ssm, ys, True)
    b_p, C_p, ell_p = pkf_from_tl(ssm_p, ys_p, True)
    npt.assert_array_equal(np.asarray(b_p[:, :T]), np.asarray(b))
    npt.assert_array_equal(np.asarray(C_p[:, :, :T]), np.asarray(C))
    npt.assert_array_equal(float(ell_p), float(ell))


def test_pad_time_axis_feeds_sharded_engine():
    # End-to-end: pad an awkward T, run the sharded filter on the full mesh.
    mesh = make_time_mesh()
    n = mesh.shape["time"]
    T = 8 * n + 3  # not divisible
    ts, ys = _series(T, seed=1)
    kernel = Matern32(variance=1.0, lengthscales=0.5)
    ssm = kernel.get_ssm_tl(ts, jnp.asarray(0.1, ts.dtype).reshape(1, 1))
    ssm_p, ys_p, _ = pad_time_axis(ssm, ys, n)
    b_sh, C_sh, ell_sh = jax.jit(
        lambda s, y: sharded_pkf_tl(s, y, mesh, return_loglikelihood=True)
    )(ssm_p, ys_p)
    _, _, ell_ref = pkf_from_tl(ssm, ys, True)
    npt.assert_allclose(float(ell_sh), float(ell_ref), rtol=1e-12)


def test_sharded_batched_lml_tl_matches_single_device():
    B = 4
    mesh = make_process_mesh(batch=2)
    n_t = mesh.shape["time"]
    T = 16 * n_t
    ts, _ = _series(T, seed=2)
    R = jnp.asarray(0.1, ts.dtype).reshape(1, 1)
    rng = np.random.RandomState(3)
    ys_b = jnp.asarray(
        np.sin(7 * np.asarray(ts[:, 0]))[None] + 0.1 * rng.randn(B, T)
    )
    variances = jnp.asarray(np.linspace(0.5, 2.0, B))

    ssm_b = jax.vmap(
        lambda v: Matern32(variance=v, lengthscales=0.4).get_ssm_tl(ts, R)
    )(variances)
    ells = jax.jit(
        lambda s, y: sharded_batched_lml_tl(s, y, mesh)
    )(ssm_b, ys_b)
    for i in range(B):
        ssm_i = jax.tree.map(lambda x: x[i], ssm_b)
        _, _, ell_ref = pkf_from_tl(ssm_i, ys_b[i].reshape(-1, 1), True)
        npt.assert_allclose(float(ells[i]), float(ell_ref), rtol=1e-12)


def test_scan_efficiency_report_smoke():
    mesh = make_time_mesh()
    rep = scan_efficiency_report(mesh, T=2**10, reps=2)
    assert rep["n_shards"] == mesh.shape["time"]
    assert rep["t_sharded_s"] > 0 and rep["t_local_shard_s"] > 0
    assert 0 < rep["efficiency"]
    assert rep["collective_payload_bytes_per_scan"] > 0
