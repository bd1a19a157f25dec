"""StateSpaceGP model-level behavior: the sorted merge, NaN injection at
query points, unsorted queries, and degenerate inputs.

These paths are untested in the reference (SURVEY.md §4 'what is not
tested'); reference semantics at pssgp/model.py:15-55 (merge), :92-111
(predict via NaN observations).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import parallel_gps_tpu as pgt
from parallel_gps_tpu.models.ssgp import merge_sorted


def _toy_model(parallel=True, n=64, seed=0):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(n))
    y = np.sin(7 * t) + 0.1 * rng.randn(n)
    kernel = pgt.kernels.Matern32(variance=1.0, lengthscales=0.3)
    return pgt.StateSpaceGP.create((t, y), kernel, 0.1, parallel=parallel)


def test_merge_sorted_matches_numpy_mergesort():
    rng = np.random.RandomState(3)
    a = np.sort(rng.rand(37))
    b = np.sort(rng.rand(21))
    av = rng.randn(37, 2)
    bv = rng.randn(21, 2)
    merged, (payload,), is_b = merge_sorted(
        jnp.asarray(a), jnp.asarray(b), (jnp.asarray(av),), (jnp.asarray(bv),)
    )
    np.testing.assert_array_equal(np.asarray(merged), np.sort(np.concatenate([a, b])))
    # Payloads travel with their keys.
    np.testing.assert_allclose(np.asarray(payload)[~np.asarray(is_b)], av)
    np.testing.assert_allclose(np.asarray(payload)[np.asarray(is_b)], bv)
    assert int(np.asarray(is_b).sum()) == 21


def test_merge_sorted_stable_on_duplicate_keys():
    a = jnp.asarray([0.0, 0.5, 1.0])
    b = jnp.asarray([0.5])
    merged, _, is_b = merge_sorted(a, b, (a[:, None],), (b[:, None],))
    np.testing.assert_array_equal(np.asarray(merged), [0.0, 0.5, 0.5, 1.0])
    # searchsorted(left) puts the b duplicate before the equal a key
    assert bool(is_b[1]) and not bool(is_b[2])


@pytest.mark.parametrize("parallel", [False, True])
def test_unsorted_queries_match_sorted(parallel):
    model = _toy_model(parallel)
    q = np.linspace(0.05, 0.95, 31)
    perm = np.random.RandomState(1).permutation(31)
    m1, v1 = model.predict_f(q)
    m2, v2 = model.predict_f(q[perm])
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1)[perm], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1)[perm], rtol=1e-10)


@pytest.mark.parametrize("parallel", [False, True])
def test_all_nan_data_predicts_prior(parallel):
    # All observations missing: LML = 0, posterior = prior (mean 0, var k(0)).
    n = 32
    t = np.linspace(0.0, 1.0, n)
    y = np.full((n,), np.nan)
    kernel = pgt.kernels.Matern32(variance=2.0, lengthscales=0.3)
    model = pgt.StateSpaceGP.create((t, y), kernel, 0.1, parallel=parallel)
    assert float(model.log_marginal_likelihood()) == 0.0
    mean, var = model.predict_f(np.asarray([0.25, 0.75]))
    np.testing.assert_allclose(np.asarray(mean), 0.0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(var), 2.0, rtol=1e-9)


@pytest.mark.parametrize("parallel", [False, True])
def test_partial_nan_equals_dropping_rows_for_lml(parallel):
    # NaN-masked updates must yield the same LML as a series without those
    # rows is NOT generally true (time grid changes), but prediction at the
    # NaN rows must equal predict_f at those times.
    model = _toy_model(parallel)
    t = np.asarray(model.ts)[:, 0]
    y = np.asarray(model.ys).copy()
    holdout = slice(20, 25)
    y[holdout] = np.nan
    masked = pgt.StateSpaceGP.create((t, y[:, 0]), model.kernel, 0.1, parallel=parallel)
    mean_direct, _ = masked.predict_f(t[holdout])
    # Smoother state at the NaN rows == prediction at those timestamps.
    m_full, _ = masked.predict_f(t[holdout] + 0.0)
    np.testing.assert_allclose(np.asarray(mean_direct), np.asarray(m_full), rtol=1e-9)
    assert np.isfinite(float(masked.log_marginal_likelihood()))


def test_prediction_bucket_reuses_compile():
    # Query batches are padded to power-of-two buckets: two different query
    # counts in one bucket must trigger exactly one trace (SURVEY §7 hard
    # part (e): static-shape replacement for the reference's dynamic-T
    # smoother signature, pssgp/model.py:73-84).
    from parallel_gps_tpu.models.ssgp import _bucket_size, _predict_f_jit

    assert _bucket_size(17) == _bucket_size(29) == 32
    model = _toy_model(parallel=False, n=48, seed=7)
    q = np.linspace(0.05, 0.95, 17)
    model.predict_f(q)
    mid = _predict_f_jit._cache_size()
    m2, v2 = model.predict_f(np.linspace(0.05, 0.95, 29))
    assert _predict_f_jit._cache_size() == mid  # same bucket: no retrace
    assert m2.shape == (29, 1) and v2.shape == (29, 1)


def test_prediction_padding_does_not_perturb():
    # Padding duplicates the last query time; posterior at the real query
    # points must be bit-comparable with an exact-bucket-size query.
    model = _toy_model(parallel=True, n=48, seed=7)
    q32 = np.linspace(0.05, 0.95, 32)  # exact bucket, no padding
    m_full, v_full = model.predict_f(q32)
    m_pad, v_pad = model.predict_f(q32[:29])  # padded up to 32
    np.testing.assert_allclose(np.asarray(m_pad), np.asarray(m_full)[:29], rtol=1e-9)
    np.testing.assert_allclose(np.asarray(v_pad), np.asarray(v_full)[:29], rtol=1e-9)


def test_predict_f_accepts_full_cov_kwarg():
    # Reference API compat: full_cov is accepted and ignored
    # (pssgp/model.py:92-96 — the reference also returns marginals only).
    model = _toy_model(parallel=False, n=32)
    m1, v1 = model.predict_f(np.asarray([0.25, 0.5]), full_cov=True)
    m2, v2 = model.predict_f(np.asarray([0.25, 0.5]))
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


def test_single_observation():
    model = pgt.StateSpaceGP.create(
        (np.asarray([0.5]), np.asarray([1.0])),
        pgt.kernels.Matern12(variance=1.0, lengthscales=1.0),
        0.1,
        parallel=False,
    )
    lml = float(model.log_marginal_likelihood())
    # N(1; 0, k(0)+R): the exact single-point marginal.
    want = -0.5 * (1.0 / 1.1) - 0.5 * np.log(2 * np.pi * 1.1)
    np.testing.assert_allclose(lml, want, rtol=1e-9)
    mean, var = model.predict_f(np.asarray([0.5]))
    np.testing.assert_allclose(float(mean[0, 0]), 1.0 / 1.1, rtol=1e-9)


def test_align_pad_invariance():
    """Shard-divisibility padding (repeated last t ⇒ dt=0 identity
    elements, NaN observations ⇒ masked) leaves LML and predictions at real
    positions unchanged — the invariant that lets the model layer pad the
    time axis to the mesh (models/ssgp.py::_align_pad)."""
    from parallel_gps_tpu.models.ssgp import _align_pad

    rng = np.random.RandomState(3)
    t = np.sort(rng.rand(100))
    y = np.sin(2 * np.pi * t) + 0.1 * rng.randn(100)
    model = pgt.StateSpaceGP.create(
        (t, y), pgt.kernels.Matern32(1.0, 0.4), 0.1, parallel=True
    )
    ts_p, ys_p = _align_pad(model.ts, model.ys, 64)
    assert ts_p.shape[0] == 128
    padded = model.replace(ts=ts_p, ys=ys_p)

    base = float(model.log_marginal_likelihood())
    np.testing.assert_allclose(
        float(padded.log_marginal_likelihood()), base, rtol=1e-12
    )
    xq = np.asarray([0.123, 0.5, 0.987])
    m0, v0 = model.predict_f(xq)
    m1, v1 = padded.predict_f(xq)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m0), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v0), rtol=1e-9)


def test_engine_dispatch(monkeypatch):
    """One dispatch rule for LML: stable → square-root engine; mesh →
    sharded time-last; parallel → time-last; else sequential."""
    import jax

    from parallel_gps_tpu.kalman import sqrt, timelast
    from parallel_gps_tpu.models import ssgp
    from parallel_gps_tpu.parallel import sharded
    from parallel_gps_tpu.parallel.sharded import make_time_mesh

    called = []

    def spy(name):
        def f(*args, **kwargs):
            called.append(name)
            return (None, None, jnp.zeros(())) if name == "kf" else jnp.zeros(())

        return f

    monkeypatch.setattr(sqrt, "sqrt_lml_kernel", spy("sqrt"))
    monkeypatch.setattr(sharded, "sharded_lml_tl", spy("sharded"))
    monkeypatch.setattr(timelast, "lml_tl", spy("timelast"))
    monkeypatch.setattr(ssgp, "kf", spy("kf"))
    t = np.sort(np.random.RandomState(0).rand(16))
    y = np.sin(2 * np.pi * t)
    k = pgt.kernels.Matern32(1.0, 0.3)
    cases = [
        (dict(stable=True), "sqrt"),
        (dict(mesh=make_time_mesh(4)), "sharded"),
        (dict(parallel=True), "timelast"),
        (dict(parallel=False), "kf"),
    ]
    with jax.disable_jit():
        for kwargs, want in cases:
            called.clear()
            pgt.StateSpaceGP.create((t, y), k, 0.1, **kwargs).log_marginal_likelihood()
            assert called == [want], (kwargs, called)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_argsort_and_inverse_permutation_match_numpy(n):
    """predict_f's int32 argsort (stable on ties) and its scatter-based
    inverse permutation equal numpy's argsort."""
    from parallel_gps_tpu.models.ssgp import _argsort, _inverse_permutation

    x = np.random.RandomState(n).randint(0, 5, size=n).astype(float)
    order = _argsort(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(order), np.argsort(x, kind="stable"))
    np.testing.assert_array_equal(
        np.asarray(_inverse_permutation(order)), np.argsort(np.asarray(order))
    )
