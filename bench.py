"""Throughput benchmark: parallel Kalman filter+smoother on one GPU.

Protocol (BASELINE.md): Matern52 (d=3) state-space GP, N=10M time steps,
float32, one card, the XLA time-last engine.  Metric = timesteps/s through
the full filter+smoother (pkfs), each call ending in ``block_until_ready``.

``vs_baseline``: the reference (EEA-sensors/parallel-gps) commits no numbers
(BASELINE.md), so the recorded baseline is the sequential O(N)-span Kalman
engine on the same card, measured at N_SEQ and extrapolated per step — the
paper's span-parallelism claim, measured.

``extras`` carries secondary rows: N=1M pkfs, LML and LML+grad (Fisher
VJP), 64 batched GPs × T=65,536 LML, and the model-API LML and training
step at the headline size.  Disable with BENCH_EXTRAS=0.

Needs a CUDA GPU: there is no CPU fallback.  Prints the card's name and
power limit, then ONE JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N_10M = int(os.environ.get("BENCH_N10M", 10_000_000))
N_1M = int(os.environ.get("BENCH_N", 1_000_000))
N_SEQ = int(os.environ.get("BENCH_N_SEQ", 8_192))
REPS = int(os.environ.get("BENCH_REPS", 6))


def _median_time(fn, *args, reps=REPS):
    """Median wall seconds of ``reps`` calls after one warm-up (compile)
    call, each ending in block_until_ready; returns (seconds, output)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def _make(kern, T, dtype, seed=0):
    import jax
    import jax.numpy as jnp

    from parallel_gps_tpu.toymodels import obs_noise, sinu

    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T)).astype(np.float32)
    y = obs_noise(sinu(t), 0.1, seed).astype(np.float32)
    ts_j = jnp.asarray(t, dtype).reshape(-1, 1)
    ssm = jax.jit(kern.get_ssm_tl)(
        ts_j, jnp.asarray(0.1, dtype).reshape(1, 1)
    )
    jax.block_until_ready(ssm)
    return ssm, jnp.asarray(y, dtype).reshape(-1, 1), ts_j


def _extras(dtype) -> dict:
    """N=1M pkfs, LML and LML+grad; batched 64 × 65,536 LML."""
    import jax
    import jax.numpy as jnp

    from parallel_gps_tpu.kalman.timelast import lml_tl, pkfs_from_tl
    from parallel_gps_tpu.kernels import Matern32
    from parallel_gps_tpu.toymodels import sinu

    out: dict = {}
    ssm, ys, _ = _make(Matern32(1.0, 0.5), N_1M, dtype)
    t_p, _ = _median_time(jax.jit(pkfs_from_tl), ssm, ys)
    out["pkfs_N1M_ms"] = round(t_p * 1e3, 3)
    t_lml, _ = _median_time(jax.jit(lml_tl), ssm, ys)
    out["lml_N1M_ms"] = round(t_lml * 1e3, 3)
    f_vg = jax.jit(jax.value_and_grad(lml_tl))
    t_vg, _ = _median_time(f_vg, ssm, ys)
    out["lml_grad_N1M_ms"] = round(t_vg * 1e3, 3)
    del ssm, ys

    B, Tb = 64, 65_536
    rng = np.random.RandomState(1)
    t64 = np.sort(rng.rand(Tb)).astype(np.float32)
    ssm_b, _, _ = _make(Matern32(1.0, 0.5), Tb, dtype, seed=1)
    ys_b = jnp.asarray(
        sinu(t64)[None] + 0.1 * rng.randn(B, Tb), dtype
    ).reshape(B, Tb, 1)
    f_b = jax.jit(jax.vmap(lambda o: lml_tl(ssm_b, o)))
    t_b, _ = _median_time(f_b, ys_b)
    out["batched64_lml_T65k_ms"] = round(t_b * 1e3, 3)
    out["batched64_lml_agg_tsps"] = round(B * Tb / t_b, 1)
    return out


def main() -> int:
    import jax
    import jax.numpy as jnp

    from parallel_gps_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a CUDA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"device_kind: {dev.device_kind}; nvidia-smi: {card}", flush=True)

    from parallel_gps_tpu.kalman.sequential import kfs
    from parallel_gps_tpu.kalman.timelast import lml_tl, pkfs_from_tl
    from parallel_gps_tpu.kernels import Matern52
    from parallel_gps_tpu.models import StateSpaceGP
    from parallel_gps_tpu.toymodels import obs_noise, sinu

    dtype = jnp.float32
    N = N_10M
    kernel = Matern52(0.8, 0.4)
    ssm, ys, ts_j = _make(kernel, N, dtype)

    t_par, (sms, sPs) = _median_time(jax.jit(pkfs_from_tl), ssm, ys)
    finite = bool(jnp.isfinite(sms).all() & jnp.isfinite(sPs).all())
    t_lml, _ = _median_time(jax.jit(lml_tl), ssm, ys)
    del sms, sPs, ssm

    # Model-API rows: LML and the full training step (value_and_grad incl.
    # discretization) through StateSpaceGP.
    t_np = np.asarray(ts_j[:, 0])
    y_np = np.asarray(ys[:, 0])
    model = StateSpaceGP.create((t_np, y_np), kernel, 0.1, dtype=dtype)
    t_mlml, _ = _median_time(lambda m: m.log_marginal_likelihood(), model)

    def _loss(p):
        m = StateSpaceGP.create(
            (t_np, y_np), Matern52(p[0], p[1]), p[2], dtype=dtype
        )
        return m.training_loss()

    f_tr = jax.jit(jax.value_and_grad(_loss))
    t_mtr, _ = _median_time(f_tr, jnp.asarray([0.8, 0.4, 0.1], dtype))
    del model, ys, ts_j

    # Baseline: sequential engine, extrapolated per step (see docstring).
    rng = np.random.RandomState(0)
    t_s = np.sort(rng.rand(N_SEQ)).astype(np.float32)
    y_s = obs_noise(sinu(t_s), 0.1, 42).astype(np.float32)
    ssm_tf = jax.jit(
        lambda ts: kernel.get_ssm(ts, jnp.asarray(0.1, dtype).reshape(1, 1))
    )(jnp.asarray(t_s, dtype).reshape(-1, 1))
    t_seq, _ = _median_time(
        jax.jit(kfs), ssm_tf, jnp.asarray(y_s, dtype).reshape(-1, 1), reps=4
    )
    tsps_seq = N_SEQ / t_seq
    tsps_par = N / t_par

    extras = {
        "lml_N10M_ms": round(t_lml * 1e3, 2),
        "model_lml_ms": round(t_mlml * 1e3, 2),
        "model_train_step_ms": round(t_mtr * 1e3, 2),
    }
    if os.environ.get("BENCH_EXTRAS", "1") != "0":
        extras.update(_extras(dtype))

    print(json.dumps({
        "metric": f"parallel filter+smoother timesteps/s, N={N}, Matern52 f32",
        "value": round(tsps_par, 1),
        "unit": "timesteps/s",
        "vs_baseline": round(tsps_par / tsps_seq, 3),
        "baseline": f"sequential-scan engine ({round(tsps_seq, 1)} timesteps/s)",
        "finite": finite,
        "wall_ms": round(t_par * 1e3, 2),
        "engine": "xla-tl",
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": card,
        },
        "extras": extras,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
