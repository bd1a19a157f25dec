"""End-to-end smoke test of parallel-gps-tpu on NVIDIA GPUs.

Drives the user-facing entry points (``StateSpaceGP``, ``inference``) at
full width on the card and checks every result against the plain
references (the sequential Kalman engine and the dense GP, in float64):

  0. device: a CUDA GPU is required — there is no CPU path;
  1. main path: Matern52, f32, N = 10,000,000 irregular times with NaN gaps
     — LML, ``fit_adam`` (5 steps), ``predict_f`` at 100,000 queries, and
     the same LML in f64;
  2. parity at T = 65,536 (Matern32/52, f32 and f64) against the sequential
     engine, and at N = 4,096 against the dense GP;
  3. the CO2 composite kernel (d = 18) on the Mauna Loa data, LML + grad in
     f32 and f64 against the sequential f64 oracle, plus what JAX's default
     (TF32-permitting) matmul precision does to the discretization;
  4. ``sample_chains``: HMC, 64 chains × T = 65,536, and the batched
     LML + grad behind each step timed as one vmap and in chunks of 32;
  5. ``stable=True``: RBF order 12, f32, T = 32,768, LML + grad.

``--multi`` runs only the time-sharded mesh path on four cards (N = 10M,
Matern52, f32: LML, ``value_and_grad`` of ``make_loss`` and ``predict_f``)
against the same model on one card.

Programs of later phases compile ahead of time on background threads
(``COMPILE_WORKERS``) while the earlier phases run, so XLA compiles
overlap; a compile time printed for such a program is its wall time on its
thread.  Every comparison prints its error beside its bound.  The last line of
standard output is one JSON object, printed only when every phase passed:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure exits non-zero without it.

Run from the repository root:

    python chip_smoke.py            # one card, phases 0-5
    python chip_smoke.py --multi    # four cards, mesh path only
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class Checks:
    """Collects every comparison (error beside bound) and phase failure, and
    compiles the programs the phases run — ahead of time on ``workers``
    background threads for the programs handed to :meth:`prefetch`, so that
    XLA compiles of later phases overlap the earlier phases."""

    def __init__(self, workers: int = 0):
        self.failures: list[str] = []
        self._pool = ThreadPoolExecutor(workers) if workers else None
        self._pending = {}

    def prefetch(self, programs) -> None:
        """Start compiling ``programs`` — (key, x64, build) triples, with
        ``build() -> (fn, args)`` — in the background."""
        if self._pool is None:
            return
        for key, x64, build in programs:
            self._pending[key] = self._pool.submit(_compile_built, x64, build)

    def compile(self, key: str, fn, *args):
        """(compiled, compile seconds, peak bytes) of ``fn`` at ``args``:
        the prefetched program under ``key`` if its compile has started,
        else compiled here."""
        future = self._pending.pop(key, None)
        if future is not None and not future.cancel():
            try:
                return future.result()
            except Exception:  # noqa: BLE001 — recompile here, report why
                traceback.print_exc()
        return _compile(fn, *args)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)

    def check(self, name: str, err: float, bound: float) -> None:
        ok = bool(np.isfinite(err)) and err <= bound
        print(f"  {name}: err={err:.3e} bound={bound:.1e} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(name)

    def require(self, name: str, cond: bool) -> None:
        print(f"  {name}: {'ok' if cond else 'FAIL'}", flush=True)
        if not cond:
            self.failures.append(name)


def _x64(enabled: bool):
    import jax

    return jax.enable_x64(enabled)


def _dtype(x64: bool):
    return np.float64 if x64 else np.float32


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _finite(*xs) -> bool:
    return all(bool(np.all(np.isfinite(np.asarray(x)))) for x in xs)


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _compile(fn, *args):
    """jit + lower + compile; returns (compiled, seconds, peak bytes)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    secs = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    peak = None
    if mem is not None:
        peak = int(
            mem.argument_size_in_bytes + mem.output_size_in_bytes
            + mem.temp_size_in_bytes - mem.alias_size_in_bytes
        )
    return compiled, secs, peak


def _compile_built(x64: bool, build):
    with _x64(x64):
        fn, args = build()
        return _compile(fn, *args)


def _steady_ms(fn, *args, reps: int = 3):
    """Median wall ms of ``reps`` calls after one warm call, each ending in
    block_until_ready; returns (ms, last output)."""
    out = _block(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _block(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times)), out


def _series(n: int, seed: int):
    """Sorted irregular times on [0, 1] and noisy sinusoid observations with
    ~10% scattered NaNs plus three contiguous 1% gaps (float64 numpy)."""
    from parallel_gps_tpu.toymodels import obs_noise, sinu

    rng = np.random.default_rng(seed)
    t = np.sort(rng.random(n))
    y = obs_noise(sinu(t), 0.1, seed)
    y[rng.random(n) < 0.1] = np.nan
    for start in rng.integers(0, max(n - n // 100, 1), size=3):
        y[start:start + n // 100] = np.nan
    return t, y


def _model(t, y, kernel, x64: bool, **kw):
    import parallel_gps_tpu as pgt

    return pgt.StateSpaceGP.create(
        (t, y), kernel, 0.1, dtype=_dtype(x64), **kw
    )


def _zeros_model(n: int, kernel, x64: bool, **kw):
    """A model of the right shapes for compiling ahead of the data."""
    return _model(np.zeros(n), np.zeros(n), kernel, x64, **kw)


def _lml(m):
    return m.log_marginal_likelihood()


def _step(m):
    """One training step — value_and_grad of make_loss at the model's
    hyperparameters — with the model (data included) as the argument, so
    that the compiled program holds no data constants."""
    import jax

    from parallel_gps_tpu.inference.optim import make_loss

    loss, u0 = make_loss(m)
    return jax.value_and_grad(loss)(u0)


def _predict_program(model, n_query: int):
    """StateSpaceGP.predict_f's jitted body at n_query queries (padded to
    its compile bucket).  predict_f compiles through its own jit, so a
    program compiled ahead here reaches it only through JAX's persistent
    compilation cache."""
    import jax.numpy as jnp

    from parallel_gps_tpu.models.ssgp import StateSpaceGP, _bucket_size

    x = jnp.zeros((_bucket_size(n_query), 1), model.ts.dtype)
    return StateSpaceGP._predict_f_impl, (model, x)


def _leaves(tree) -> np.ndarray:
    import jax

    return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])


def _mib(b) -> str:
    return "n/a" if b is None else f"{b / 2**20:.1f} MiB"


# ---------------------------------------------------------------------------
# Phase 0: the device
# ---------------------------------------------------------------------------


def phase0_device(expect_count: int = 1) -> dict:
    """Require a CUDA GPU (no CPU path) and print what runs the smoke."""
    import jax

    from parallel_gps_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a CUDA GPU, JAX found platform {platform!r}"
        )
    if len(devs) < expect_count:
        raise SystemExit(
            f"chip_smoke: needs {expect_count} GPUs, JAX found {len(devs)}"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device_kind: {devs[0].device_kind}")
    print(f"device_count: {len(devs)}")
    print(f"jax: {jax.__version__}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compilation cache: {jax.config.jax_compilation_cache_dir}")
    print(f"nvidia-smi: {smi}", flush=True)
    return {"platform": platform, "kind": devs[0].device_kind,
            "count": expect_count}


# ---------------------------------------------------------------------------
# Phase 1: the main path at full width
# ---------------------------------------------------------------------------


def _p1_kernel():
    from parallel_gps_tpu.kernels import Matern52

    return Matern52(variance=1.0, lengthscales=0.1)


def phase1_programs(n: int = 10_000_000, n_query: int = 100_000, **_):
    k = _p1_kernel()
    return [
        (f"p1 lml f32 n={n}", False, lambda: (_lml, (_zeros_model(n, k, False),))),
        (f"p1 predict n={n}", False,
         lambda: _predict_program(_zeros_model(n, k, False), n_query)),
        (f"p1 step f32 n={n}", False, lambda: (_step, (_zeros_model(n, k, False),))),
        (f"p1 lml f64 n={n}", True, lambda: (_lml, (_zeros_model(n, k, True),))),
    ]


def phase1_main(checks: Checks, n: int = 10_000_000, n_query: int = 100_000,
                n_steps: int = 5, seed: int = 0) -> dict:
    """Matern52 StateSpaceGP on n irregular, gappy steps: LML, fit_adam,
    predict_f, and the same LML in f64."""
    import jax

    from parallel_gps_tpu.inference import fit_adam

    t, y = _series(n, seed)
    kernel = _p1_kernel()
    out = {}
    with _x64(False):
        model = _model(t, y, kernel, False)
        lml_c, secs, peak = checks.compile(f"p1 lml f32 n={n}", _lml, model)
        ms, lml32 = _steady_ms(lml_c, model)
        print(f"  lml f32: {float(lml32):.6e}  compile {secs:.1f} s  "
              f"steady {ms:.2f} ms  peak {_mib(peak)}")
        out.update(lml_compile_s=secs, lml_ms=ms, lml_peak_bytes=peak)
        checks.require("phase1 lml finite", _finite(lml32))

        t0 = time.perf_counter()
        fitted, history = fit_adam(model, n_iters=n_steps, learning_rate=0.01)
        history = np.asarray(_block(history))
        fit_s = time.perf_counter() - t0
        print(f"  fit_adam {n_steps} steps (incl. compile): {fit_s:.1f} s  "
              f"loss {history[0]:.6e} -> {history[-1]:.6e}")
        checks.require("phase1 loss finite", _finite(history))
        rise = float(np.max(np.diff(history) / np.abs(history[:-1])))
        # f32 rounding of a loss summed over n terms: allow 1e-6 relative.
        checks.check("phase1 loss rise per step (rel)", max(rise, 0.0), 1e-6)

        step_c, secs, peak = checks.compile(f"p1 step f32 n={n}", _step, model)
        ms, (val, grads) = _steady_ms(step_c, model)
        print(f"  training step (value_and_grad): compile {secs:.1f} s  "
              f"steady {ms:.2f} ms  peak {_mib(peak)}")
        out.update(step_compile_s=secs, step_ms=ms, step_peak_bytes=peak)
        checks.require("phase1 grad finite", _finite(val, _leaves(grads)))

        xq = np.random.default_rng(seed + 1).random(n_query)
        t0 = time.perf_counter()
        mean, var = _block(fitted.predict_f(xq))
        first_s = time.perf_counter() - t0
        ms, (mean, var) = _steady_ms(fitted.predict_f, xq, reps=2)
        print(f"  predict_f {n_query} queries: first {first_s:.1f} s  "
              f"steady {ms:.2f} ms")
        out.update(predict_first_s=first_s, predict_ms=ms)
        checks.require("phase1 predict shapes",
                       mean.shape == (n_query, 1) and var.shape == (n_query, 1))
        checks.require("phase1 predict finite", _finite(mean, var))
        checks.require("phase1 predict var > 0",
                       bool(np.all(np.asarray(var) > 0)))
    with _x64(True):
        model64 = _model(t, y, kernel, True)
        lml64_c, secs, peak = checks.compile(f"p1 lml f64 n={n}", _lml, model64)
        ms, lml64 = _steady_ms(lml64_c, model64)
        print(f"  lml f64: {float(lml64):.10e}  compile {secs:.1f} s  "
              f"steady {ms:.2f} ms  peak {_mib(peak)}")
        out.update(lml64_ms=ms)
    # f32 filtering of n steps against the same model in f64: per-step
    # roundoff ~1e-7 accumulates, held to the 1e-4 starting bound.
    checks.check("phase1 lml f32 vs f64 (rel)", _rel(lml32, lml64), 1e-4)
    peak_use = jax.devices()[0].memory_stats() or {}
    print(f"  device peak_bytes_in_use: "
          f"{_mib(peak_use.get('peak_bytes_in_use'))}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 2: parity against the plain references
# ---------------------------------------------------------------------------


def _R(m):
    return m.noise_variance.reshape(1, 1)


def _p2_oracle(m):
    """Sequential engine: LML and smoothed moments."""
    from parallel_gps_tpu.kalman import kfs

    return _lml(m), kfs(m.kernel.get_ssm(m.ts, _R(m)), m.ys)


def _p2_timelast(m):
    """Time-last engine: the model's LML and pkfs' smoothed moments."""
    from parallel_gps_tpu.kalman import pkfs

    return _lml(m), pkfs(m.kernel.get_ssm_tl(m.ts, _R(m)), m.ys)


def _p2_dense(g, x):
    return g.log_marginal_likelihood(), g.predict_f(x)


def _p2_kernels():
    from parallel_gps_tpu.kernels import Matern32, Matern52

    return (Matern32(1.0, 0.2), Matern52(0.8, 0.1))


def _p2_dense_data(n_dense: int, seed: int):
    t, y = _series(n_dense, seed + 1)
    keep = ~np.isnan(y)  # the dense GP has no missing-data path
    return t[keep], y[keep], np.linspace(0.01, 0.99, 257)


def _gpr(model, kernel):
    from parallel_gps_tpu.models import GPR

    return GPR(ts=model.ts, ys=model.ys, kernel=kernel,
               noise_variance=model.noise_variance)


def phase2_programs(T: int = 65_536, n_dense: int = 4_096, seed: int = 1, **_):
    import jax.numpy as jnp

    progs = []
    for k in _p2_kernels():
        name = type(k).__name__
        progs.append((f"p2 {name} oracle T={T}", True, lambda k=k: (
            _p2_oracle, (_zeros_model(T, k, True, parallel=False),))))
        for x64 in (True, False):
            progs.append((f"p2 {name} tl x64={x64} T={T}", x64,
                          lambda k=k, x64=x64: (
                              _p2_timelast, (_zeros_model(T, k, x64),))))

    def dense():
        t, _, xq = _p2_dense_data(n_dense, seed)
        k = _p2_kernels()[1]
        g = _gpr(_zeros_model(len(t), k, True), k)
        return _p2_dense, (g, jnp.zeros((len(xq), 1)))

    progs.append((f"p2 dense n={n_dense}", True, dense))
    return progs


def phase2_parity(checks: Checks, T: int = 65_536, n_dense: int = 4_096,
                  seed: int = 1) -> dict:
    """Time-last engine (through StateSpaceGP and pkfs) vs the sequential
    f64 engine at T, and vs the dense GP at n_dense."""
    import jax.numpy as jnp

    t, y = _series(T, seed)
    out = {}
    for kernel in _p2_kernels():
        name = type(kernel).__name__
        with _x64(True):
            oracle = _model(t, y, kernel, True, parallel=False)
            f, _, _ = checks.compile(f"p2 {name} oracle T={T}", _p2_oracle,
                                     oracle)
            lml_ref, (m_ref, P_ref) = f(oracle)
        results = {}
        for x64 in (True, False):
            with _x64(x64):
                model = _model(t, y, kernel, x64)
                f, _, _ = checks.compile(f"p2 {name} tl x64={x64} T={T}",
                                         _p2_timelast, model)
                lml, (m, P) = f(model)
                results[x64] = (float(lml), np.asarray(m), np.asarray(P))
        lml_ref = float(lml_ref)
        m_ref, P_ref = np.asarray(m_ref), np.asarray(P_ref)
        for x64, bounds in ((True, (1e-10, 1e-8)), (False, (1e-4, 1e-3))):
            lml, m, P = results[x64]
            tag = f"phase2 {name} T={T} {'f64' if x64 else 'f32'}"
            checks.check(f"{tag} lml (rel)", abs(lml - lml_ref) / abs(lml_ref),
                         bounds[0])
            checks.check(f"{tag} smoothed mean (/max|mean|)", _rel(m, m_ref),
                         bounds[1])
            checks.check(f"{tag} smoothed cov (/max|cov|)", _rel(P, P_ref),
                         bounds[1])
        out[name] = results[False][0]

    t_d, y_d, xq = _p2_dense_data(n_dense, seed)
    kernel = _p2_kernels()[1]
    with _x64(True):
        model = _model(t_d, y_d, kernel, True)
        gp = _gpr(model, kernel)
        xq_j = jnp.asarray(xq).reshape(-1, 1)
        f, _, _ = checks.compile(f"p2 dense n={n_dense}", _p2_dense, gp, xq_j)
        lml_gp, (mq_gp, vq_gp) = f(gp, xq_j)
        lml_gp = float(lml_gp)
        lml_ss = float(model.log_marginal_likelihood())
        mq, vq = model.predict_f(xq)
    # Dense Cholesky roundoff grows with N·cond(K)·eps: 1e-8 relative.
    checks.check(f"phase2 dense GP N={len(t_d)} lml (rel)",
                 abs(lml_ss - lml_gp) / abs(lml_gp), 1e-8)
    checks.check("phase2 dense GP predict mean (/max|mean|)",
                 _rel(mq, mq_gp), 1e-6)
    checks.check("phase2 dense GP predict var (rel)", _rel(vq, vq_gp), 1e-6)
    return out


# ---------------------------------------------------------------------------
# Phase 3: the CO2 composite (d = 18)
# ---------------------------------------------------------------------------


def _ssm_tl_default_precision(kernel, ts, R):
    """The cancellation-free discretization of ops/disc.py with its matrix
    products at JAX's default precision (TF32 on a GPU) — what the program
    computed before the products were pinned to HIGHEST — laid out
    time-last."""
    import jax.numpy as jnp

    from parallel_gps_tpu.ops.linalg import symmetrize
    from parallel_gps_tpu.types import LGSSMTL

    sde = kernel.get_sde()
    t = ts.reshape(-1)
    dts = t - jnp.concatenate([jnp.zeros((1,), t.dtype), t[:-1]])
    Am1 = kernel.transitions_m1(dts)
    P0 = symmetrize(sde.P0)
    AP = jnp.matmul(Am1, P0)
    Qs = symmetrize(-(AP + jnp.swapaxes(AP, -1, -2)
                      + jnp.matmul(AP, jnp.swapaxes(Am1, -1, -2))))
    Fs = Am1 + jnp.eye(P0.shape[0], dtype=P0.dtype)
    return LGSSMTL(P0, jnp.moveaxis(Fs, 0, -1), jnp.moveaxis(Qs, 0, -1),
                   sde.H, R)


def _p3_tf32(m):
    """The model's time-last f32 LML, with the discretization products at
    the default precision."""
    from parallel_gps_tpu.kalman.timelast import lml_tl

    return lml_tl(_ssm_tl_default_precision(m.kernel, m.ts, _R(m)), m.ys)


def _p3_setup(n: int, qp_order: int, data_dir):
    from parallel_gps_tpu.experiments.co2.common import (
        get_covariance_function,
        get_data,
    )

    t, y = get_data(n, data_dir)
    return t[:, 0], y[:, 0] - np.mean(y), get_covariance_function(qp_order)


def phase3_programs(n: int = 3_192, qp_order: int = 3, data_dir=None, **_):
    t, _, k = _p3_setup(n, qp_order, data_dir)
    m = len(t)
    return [
        (f"p3 oracle n={m} qp={qp_order}", True,
         lambda: (_step, (_zeros_model(m, k, True, parallel=False),))),
        (f"p3 tl x64=True n={m} qp={qp_order}", True,
         lambda: (_step, (_zeros_model(m, k, True),))),
        (f"p3 tl x64=False n={m} qp={qp_order}", False,
         lambda: (_step, (_zeros_model(m, k, False),))),
        (f"p3 tf32 n={m} qp={qp_order}", False,
         lambda: (_p3_tf32, (_zeros_model(m, k, False),))),
    ]


def phase3_co2(checks: Checks, n: int = 3_192, qp_order: int = 3,
               data_dir: str | None = None) -> dict:
    """LML + grad of the CO2 composite on the Mauna Loa data, f32 and f64,
    against the sequential f64 oracle."""
    t, y, kernel = _p3_setup(n, qp_order, data_dir)
    m = len(t)
    print(f"  n={m} state_dim={kernel.state_dim}")
    out = {}
    with _x64(True):
        oracle = _model(t, y, kernel, True, parallel=False)
        f, _, _ = checks.compile(f"p3 oracle n={m} qp={qp_order}", _step,
                                 oracle)
        v_ref, g_ref = f(oracle)
        g_ref, v_ref = _leaves(g_ref), float(v_ref)
    for x64, bounds in ((True, (1e-10, 1e-6)), (False, (1e-4, 1e-2))):
        with _x64(x64):
            model = _model(t, y, kernel, x64)
            vg, secs, peak = checks.compile(
                f"p3 tl x64={x64} n={m} qp={qp_order}", _step, model
            )
            ms, (v, g) = _steady_ms(vg, model)
            g = _leaves(g)
        tag = f"phase3 co2 d={kernel.state_dim} {'f64' if x64 else 'f32'}"
        print(f"  {tag}: loss {float(v):.10e}  compile {secs:.1f} s  "
              f"steady {ms:.2f} ms  peak {_mib(peak)}")
        checks.check(f"{tag} loss (rel)", abs(float(v) - v_ref) / abs(v_ref),
                     bounds[0])
        checks.check(f"{tag} grad (rel, max-norm)", _rel(g, g_ref), bounds[1])
        out[f"lml_grad_ms_{'f64' if x64 else 'f32'}"] = ms
    # The TF32 observation: the f32 LML above with its discretization
    # products at the default precision instead of pinned.
    with _x64(False):
        model = _model(t, y, kernel, False)
        f, _, _ = checks.compile(f"p3 tf32 n={m} qp={qp_order}", _p3_tf32,
                                 model)
        lml_def = float(f(model))
    err_def = abs(-lml_def - v_ref) / abs(v_ref)
    err_pin = abs(float(v) - v_ref) / abs(v_ref)
    print(f"  TF32 observation (f32 LML vs f64 oracle): discretization "
          f"products at default precision {err_def:.3e}, pinned HIGHEST "
          f"{err_pin:.3e}", flush=True)
    out.update(tf32_default_rel_err=err_def, pinned_rel_err=err_pin)
    return out


# ---------------------------------------------------------------------------
# Phase 4: many MCMC chains
# ---------------------------------------------------------------------------


def _p4_setup(model, n_chains: int, seed: int):
    """(log_post, unravel, initial positions (n_chains, dim)) of HMC over
    the model's unconstrained hyperparameters."""
    import jax
    from jax.flatten_util import ravel_pytree

    from parallel_gps_tpu.inference.optim import make_log_posterior

    log_post, u0 = make_log_posterior(model)
    flat0, unravel = ravel_pytree(u0)
    jitter = 0.05 * jax.random.normal(
        jax.random.PRNGKey(seed), (n_chains, flat0.shape[0]), flat0.dtype
    )
    return log_post, unravel, flat0[None] + jitter


def _p4_batched(chunk):
    """fn(model, xs): the batched LML + grad behind each HMC step at the
    positions xs — one vmap, or lax.map over vmapped chunks of ``chunk``
    (sample_chains' chunk_size)."""
    import jax
    from jax.flatten_util import ravel_pytree

    from parallel_gps_tpu.inference.optim import make_log_posterior

    def fn(model, xs):
        log_post, u0 = make_log_posterior(model)
        unravel = ravel_pytree(u0)[1]
        vg = jax.vmap(jax.value_and_grad(lambda x: log_post(unravel(x))))
        if chunk is None or xs.shape[0] <= chunk:
            return vg(xs)
        v, g = jax.lax.map(vg, xs.reshape((-1, chunk) + xs.shape[1:]))
        return v.reshape(-1), g.reshape(xs.shape)

    return fn


def _p4_kernel():
    from parallel_gps_tpu.kernels import Matern32

    return Matern32(1.0, 0.2)


def phase4_programs(n_chains: int = 64, T: int = 65_536, seed: int = 2, **_):
    def build(chunk):
        model = _zeros_model(T, _p4_kernel(), False)
        return _p4_batched(chunk), (model, _p4_setup(model, n_chains, seed)[2])

    return [(f"p4 batched chunk={c} B={n_chains} T={T}", False,
             lambda c=c: build(c)) for c in (32, None)]


def phase4_chains(checks: Checks, n_chains: int = 64, T: int = 65_536,
                  n_samples: int = 3, seed: int = 2) -> dict:
    """sample_chains with HMC over Matern32 hyperparameters; times the
    batched LML + grad as one vmap and in chunks of 32."""
    import jax

    from parallel_gps_tpu.inference import hmc_kernel, sample_chains

    t, y = _series(T, seed)
    out = {}
    with _x64(False):
        model = _model(t, y, _p4_kernel(), False)
        log_post, unravel, xs = _p4_setup(model, n_chains, seed)
        kernel = hmc_kernel(lambda x: log_post(unravel(x)), step_size=0.005,
                            num_leapfrog_steps=3)
        t0 = time.perf_counter()
        samples, acc = sample_chains(
            kernel, jax.vmap(unravel)(xs), log_post,
            jax.random.PRNGKey(seed + 1), n_samples, 0,
        )
        _block((samples, acc))
        wall = time.perf_counter() - t0
        acc = float(np.mean(np.asarray(acc)))
        print(f"  sample_chains: {n_chains} chains x {n_samples} samples, "
              f"{wall:.1f} s incl. compile, acceptance {acc:.3f}")
        out["sample_chains_s"] = wall
        checks.require("phase4 samples finite", _finite(_leaves(samples)))
        checks.require("phase4 acceptance in (0, 1]", 0.0 < acc <= 1.0)

        for chunk in (32, None):
            compiled, secs, peak = checks.compile(
                f"p4 batched chunk={chunk} B={n_chains} T={T}",
                _p4_batched(chunk), model, xs,
            )
            ms, (v, g) = _steady_ms(compiled, model, xs)
            print(f"  batched LML+grad chunk_size={chunk}: compile "
                  f"{secs:.1f} s  steady {ms:.2f} ms  peak {_mib(peak)}",
                  flush=True)
            checks.require(f"phase4 chunk={chunk} batched grad finite",
                           _finite(v, g))
            out[f"batched_vg_ms_chunk_{chunk}"] = ms
    return out


# ---------------------------------------------------------------------------
# Phase 5: the square-root engine
# ---------------------------------------------------------------------------


def _p5_kernel(order: int):
    from parallel_gps_tpu.kernels import RBF

    return RBF(1.0, 0.1, order=order)


def phase5_programs(T: int = 32_768, order: int = 12, **_):
    return [(f"p5 stable T={T} order={order}", False, lambda: (_step, (
        _zeros_model(T, _p5_kernel(order), False, stable=True),)))]


def phase5_stable(checks: Checks, T: int = 32_768, order: int = 12,
                  seed: int = 3) -> dict:
    """stable=True, RBF order ``order``, f32: LML + grad finite."""
    t, y = _series(T, seed)
    with _x64(False):
        model = _model(t, y, _p5_kernel(order), False, stable=True)
        vg, secs, peak = checks.compile(f"p5 stable T={T} order={order}",
                                        _step, model)
        ms, (v, g) = _steady_ms(vg, model)
    print(f"  stable RBF order {order} T={T}: loss {float(v):.6e}  compile "
          f"{secs:.1f} s  steady {ms:.2f} ms  peak {_mib(peak)}", flush=True)
    checks.require("phase5 loss and grad finite", _finite(v, _leaves(g)))
    return {"lml_grad_ms": ms}


# ---------------------------------------------------------------------------
# --multi: the time-sharded mesh path on four cards
# ---------------------------------------------------------------------------


def _mesh_model(single, mesh):
    """``single`` with its series laid out over the mesh's time axis."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rows = NamedSharding(mesh, P("time", None))
    return single.replace(ts=jax.device_put(single.ts, rows),
                          ys=jax.device_put(single.ys, rows), mesh=mesh)


def multi_programs(n: int = 10_000_000, n_devices: int = 4,
                   n_query: int = 100_000, **_):
    from parallel_gps_tpu.parallel.sharded import make_time_mesh

    k = _p1_kernel()

    def model(name):
        m = _zeros_model(n, k, False)
        return m if name == "single" else _mesh_model(m, make_time_mesh(n_devices))

    progs = []
    for name in ("single", "mesh"):
        progs.append((f"multi {name} lml n={n}", False,
                      lambda name=name: (_lml, (model(name),))))
        progs.append((f"multi {name} step n={n}", False,
                      lambda name=name: (_step, (model(name),))))
        progs.append((f"multi {name} predict n={n}", False,
                      lambda name=name: _predict_program(model(name), n_query)))
    return progs


def multi_mesh(checks: Checks, n: int = 10_000_000, n_devices: int = 4,
               n_query: int = 100_000, seed: int = 0) -> dict:
    """StateSpaceGP with a 1-D "time" mesh over ``n_devices`` cards vs the
    same model on one card, in one process: LML, value_and_grad of
    make_loss, predict_f."""
    from parallel_gps_tpu.parallel.sharded import make_time_mesh

    t, y = _series(n, seed)
    xq = np.random.default_rng(seed + 1).random(n_query)
    kernel = _p1_kernel()
    out = {}
    with _x64(False):
        single = _model(t, y, kernel, False)
        sharded = _mesh_model(single, make_time_mesh(n_devices))
        spans = [len(x.sharding.device_set) for x in (sharded.ts, sharded.ys)]
        checks.require(f"multi inputs span {n_devices} devices (ts, ys: "
                       f"{spans})", spans == [n_devices, n_devices])
        res = {}
        for name, model in (("single", single), ("mesh", sharded)):
            lml_c, secs, peak = checks.compile(f"multi {name} lml n={n}",
                                               _lml, model)
            lml_ms, lml = _steady_ms(lml_c, model)
            vg_c, vg_secs, vg_peak = checks.compile(
                f"multi {name} step n={n}", _step, model
            )
            vg_ms, (v, g) = _steady_ms(vg_c, model)
            t0 = time.perf_counter()
            mean, var = _block(model.predict_f(xq))
            pr_first = time.perf_counter() - t0
            pr_ms, (mean, var) = _steady_ms(model.predict_f, xq, reps=2)
            print(f"  {name}: lml {float(lml):.6e} (compile {secs:.1f} s, "
                  f"{lml_ms:.2f} ms, peak {_mib(peak)}); step (compile "
                  f"{vg_secs:.1f} s, {vg_ms:.2f} ms, peak {_mib(vg_peak)}); "
                  f"predict_f (first {pr_first:.1f} s, {pr_ms:.2f} ms)",
                  flush=True)
            g = _leaves(g)
            res[name] = (float(lml), g, np.asarray(mean), np.asarray(var))
            out[f"{name}_lml_ms"] = lml_ms
            out[f"{name}_step_ms"] = vg_ms
            out[f"{name}_predict_ms"] = pr_ms
            checks.require(f"multi {name} finite",
                           _finite(lml, g, mean, var)
                           and bool(np.all(res[name][3] > 0)))
    (l1, g1, m1, v1), (l4, g4, m4, v4) = res["single"], res["mesh"]
    # Both f32; the shards only reassociate the scans, so the two agree to
    # f32 roundoff accumulated over n steps.  Posterior variances are small
    # differences of prior-scale quantities, so their roundoff is ~eps32
    # times the prior variance k(0): bound 1e-5 · k(0) (~100 ulps).
    checks.check("multi lml mesh vs single (rel)", abs(l4 - l1) / abs(l1), 1e-5)
    checks.check("multi grad mesh vs single (rel, max-norm)", _rel(g4, g1), 1e-3)
    checks.check("multi predict mean (/max|mean|)", _rel(m4, m1), 1e-3)
    checks.check("multi predict var (/k(0))",
                 float(np.max(np.abs(v4 - v1))) / float(kernel.variance), 1e-5)
    return out


# ---------------------------------------------------------------------------


def _run_phase(checks: Checks, title: str, fn, *args, **kwargs):
    print(f"== {title}", flush=True)
    t0 = time.perf_counter()
    try:
        res = fn(checks, *args, **kwargs)
    except Exception:  # noqa: BLE001 — report the phase and go on
        traceback.print_exc()
        checks.failures.append(f"{title}: exception")
        res = None
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
    return res


# Threads compiling later phases' programs while earlier phases run.
COMPILE_WORKERS = 6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="four cards: run only the time-sharded mesh path")
    p.add_argument("--data-dir", default=None,
                   help="directory with the Mauna Loa CO2 files")
    args = p.parse_args(argv)

    n_cards = 4 if args.multi else 1
    device = phase0_device(n_cards)
    checks = Checks(COMPILE_WORKERS)
    if args.multi:
        plan = [("multi: time-sharded mesh vs one card", multi_mesh,
                 multi_programs, dict(n_devices=n_cards))]
    else:
        plan = [
            ("phase 1: main path", phase1_main, phase1_programs, {}),
            ("phase 2: parity", phase2_parity, phase2_programs, {}),
            ("phase 3: CO2 composite", phase3_co2, phase3_programs,
             dict(data_dir=args.data_dir)),
            ("phase 4: chains", phase4_chains, phase4_programs, {}),
            ("phase 5: stable engine", phase5_stable, phase5_programs, {}),
        ]
    t0 = time.perf_counter()
    print(f"compiling ahead on {COMPILE_WORKERS} threads", flush=True)
    # The slowest compiles (the d=18 and square-root programs) go first.
    for _, _, programs, kwargs in plan[::-1]:
        checks.prefetch(programs(**kwargs))
    try:
        for title, phase, _, kwargs in plan:
            _run_phase(checks, title, phase, **kwargs)
    finally:
        checks.close()
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if checks.failures:
        print("FAILED: " + "; ".join(checks.failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
