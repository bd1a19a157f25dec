"""Multi-host initialization, process-spanning meshes, T-padding, and the
scan-efficiency harness.

The reference is strictly single-process (SURVEY.md §0); this module is the
entry point for running the time-axis-sharded engines (parallel/sharded.py)
across hosts — SURVEY §7 PR5 / the BASELINE.json north star (N=10M over ≥2
hosts at ≥70% scaling efficiency).  It provides:

  - :func:`initialize` — ``jax.distributed.initialize`` wrapper that is a
    safe no-op for single-process runs (so the same script works on one
    machine or on several hosts launched once per host);
  - :func:`make_process_mesh` — a mesh over ALL processes' devices with a
    ``time`` axis (optionally batch × time), laid out so the time axis's
    neighboring shards sit on neighboring devices (the per-scan collective is
    one tiny all_gather of boundary elements — it stays inside a host and
    only crosses the network at host boundaries);
  - :func:`pad_time_axis` — the T-divisibility helper the sharded engines'
    layout contract demands (parallel/sharded.py:14-16): pad with exact
    no-op steps (F=I, Q=0, y=NaN — identity elements of both scans);
  - :func:`scan_efficiency_report` — measures local-scan vs distributed-scan
    time on the current mesh and reports the collective payload, runnable on
    a virtual CPU mesh and on real devices unchanged.
"""
from __future__ import annotations

import time
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.sharding import Mesh

from parallel_gps_tpu.types import LGSSM, LGSSMTL


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Any = None,
) -> int:
    """Initialize JAX's distributed runtime; returns the process count.

    No-op (returns 1) when no coordinator is configured and no coordinator
    environment variable is present — single-process scripts run
    unchanged.  On several hosts, call once per host before any device use,
    with ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``.
    """
    import os

    already = getattr(jax.distributed, "is_initialized", None)
    if callable(already) and jax.distributed.is_initialized():
        return jax.process_count()
    cluster_env = any(
        v in os.environ
        for v in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
    )
    if coordinator_address is None and not cluster_env:
        return 1
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    return jax.process_count()


def make_process_mesh(
    batch: int = 1,
    batch_axis: str = "batch",
    time_axis: str = "time",
) -> Mesh:
    """Mesh over every device of every process: (batch × time).

    Device order follows ``jax.devices()`` (process-major), so consecutive
    time shards live on the same host's devices first — boundary-element
    exchanges stay inside a host except at host boundaries, which is the
    layout the two-level scan wants (one element crosses the network per
    host pair, per scan).
    """
    devs = jax.devices()
    n = len(devs)
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    return Mesh(
        np.asarray(devs).reshape(batch, n // batch), (batch_axis, time_axis)
    )


def pad_time_axis(lgssm, observations: Array, multiple: int):
    """Pad the time axis to a multiple of ``multiple`` with exact no-op steps.

    Padding steps have F=I, Q=0 and a NaN observation: their filtering
    element is the identity (A=I, b=0, C=0, J=0, eta=0) and their smoothing
    element is the identity too, so every real timestep's result — and the
    log-likelihood (NaN rows contribute 0) — is bitwise unaffected; the pad
    appends at the END so prefixes of real steps are untouched.

    Accepts LGSSM ((T, d, d) transitions) or LGSSMTL ((d, d, T)); returns
    (padded_lgssm, padded_observations, T_original).
    """
    time_last = isinstance(lgssm, LGSSMTL)
    P0, Fs, Qs, H, R = lgssm
    d = P0.shape[0]
    dtype = P0.dtype
    T = Fs.shape[-1] if time_last else Fs.shape[0]
    Tp = -(-T // multiple) * multiple
    pad = Tp - T
    if pad == 0:
        return lgssm, observations, T
    eye = jnp.eye(d, dtype=dtype)
    zero = jnp.zeros((d, d), dtype)
    if time_last:
        Fs_p = jnp.concatenate(
            [Fs, jnp.broadcast_to(eye[:, :, None], (d, d, pad))], axis=-1
        )
        Qs_p = jnp.concatenate(
            [Qs, jnp.broadcast_to(zero[:, :, None], (d, d, pad))], axis=-1
        )
        out = LGSSMTL(P0, Fs_p, Qs_p, H, R)
    else:
        Fs_p = jnp.concatenate(
            [Fs, jnp.broadcast_to(eye, (pad, d, d))], axis=0
        )
        Qs_p = jnp.concatenate(
            [Qs, jnp.broadcast_to(zero, (pad, d, d))], axis=0
        )
        out = LGSSM(P0, Fs_p, Qs_p, H, R)
    obs = observations.reshape(T, -1)
    obs_p = jnp.concatenate(
        [obs, jnp.full((pad, obs.shape[1]), jnp.nan, obs.dtype)], axis=0
    )
    return out, obs_p, T


def scan_efficiency_report(
    mesh: Mesh,
    T: int = 2**17,
    d: int = 2,
    time_axis: str = "time",
    dtype=jnp.float32,
    reps: int = 5,
) -> dict:
    """Measure distributed-scan overhead on ``mesh``: wall time of the
    sharded filter (local scans + boundary-element all_gather + prefix
    fix-up) vs the pure local scan at the same per-shard size, plus the
    analytic collective payload.

    ``efficiency`` is the weak-scaling proxy t_local / t_sharded: the
    fraction of the distributed wall spent doing useful local scan work.
    On a virtual CPU mesh the collectives are memcpys, so this measures the
    algorithmic overhead (fix-up pass + prefix recompute); on real devices
    the same harness captures interconnect latency.

    ``d``: 1–3 use the Matérn family; d > 3 uses RBF(order=d) — the sharded
    combine runs the Schur-recursed d-generic operator there."""
    from parallel_gps_tpu.kalman.timelast import (
        _filtering_elements_from_planes,
        filtering_identity_tl,
        filtering_operator_tl,
        kogge_stone_scan_tl,
    )
    from parallel_gps_tpu.kernels import RBF, Matern12, Matern32, Matern52
    from parallel_gps_tpu.parallel.sharded import sharded_pkf_tl

    kernel_cls = {1: Matern12, 2: Matern32, 3: Matern52}.get(d)
    if kernel_cls is not None:
        kernel = kernel_cls(variance=1.0, lengthscales=0.5)
    else:
        kernel = RBF(variance=1.0, lengthscales=0.25, order=d, balancing_iter=10)

    from jax.sharding import NamedSharding, PartitionSpec

    n_shards = mesh.shape[time_axis]
    T = -(-T // n_shards) * n_shards
    rng = np.random.RandomState(0)
    t = np.sort(rng.rand(T))
    ts = jnp.asarray(t, dtype).reshape(-1, 1)
    ys = jnp.asarray(np.sin(7 * t) + 0.1 * rng.randn(T), dtype).reshape(-1, 1)
    ssm = jax.jit(kernel.get_ssm_tl)(ts, jnp.asarray(0.1, dtype).reshape(1, 1))
    # Shard the SSM planes and observations over the time axis up front —
    # otherwise GSPMD receives replicated inputs and pays a full reshard
    # (and redundant element construction) inside the measured region,
    # which is not what a production caller (whose data is born sharded)
    # would see.
    def shard(x):
        if x.ndim and x.shape[-1] == T:
            spec = PartitionSpec(*([None] * (x.ndim - 1) + [time_axis]))
        elif x.ndim and x.shape[0] == T:
            spec = PartitionSpec(time_axis)
        else:
            spec = PartitionSpec()
        return jax.device_put(x, NamedSharding(mesh, spec))

    ssm = jax.tree.map(shard, ssm)
    ys = shard(ys)
    jax.block_until_ready(ssm)

    def _timed(fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    sharded = jax.jit(lambda s, y: sharded_pkf_tl(s, y, mesh, axis=time_axis))
    t_sharded = _timed(sharded, ssm, ys)

    # Pure local scan at the per-shard size (the useful-work denominator),
    # on the same engine the sharded path runs per shard.
    T_loc = T // n_shards
    ssm_loc = jax.tree.map(
        lambda x: x[..., :T_loc] if x.ndim and x.shape[-1] == T else x, ssm
    )

    def local(s, y):
        e = _filtering_elements_from_planes(s.P0, s.Fs, s.Qs, s.H, s.R, y)
        return kogge_stone_scan_tl(
            filtering_operator_tl, e, filtering_identity_tl(d, dtype)
        )

    t_local = _timed(jax.jit(local), ssm_loc, ys[:T_loc])

    n_planes = 3 * d * d + 2 * d
    payload_bytes = int(
        n_shards * n_planes * jnp.dtype(dtype).itemsize
    )  # one all_gather of per-shard totals per scan
    return {
        "n_shards": int(n_shards),
        "T": int(T),
        "d": int(d),
        "t_sharded_s": t_sharded,
        "t_local_shard_s": t_local,
        "efficiency": t_local / t_sharded if t_sharded > 0 else float("nan"),
        "collective_payload_bytes_per_scan": payload_bytes,
        "devices": [str(dev) for dev in mesh.devices.flat][:4],
    }
