"""Time-axis-sharded Kalman filtering/smoothing over a device mesh.

The reference is single-device (SURVEY.md §0); this module is the scale-out
path: shard the T axis of the LGSSM and observations over a mesh axis
(``"time"``), construct scan elements as embarrassingly-parallel per-timestep
work (GSPMD partitions it from the sharding annotations), and run the
associative scans through :func:`sharded_associative_scan` inside
``shard_map`` — one tiny ``all_gather`` of per-shard totals per scan over
the device interconnect.

Everything is differentiable end-to-end, so LML gradients for hyperparameter
optimization work across hosts.

Layout contract: T must be divisible by the mesh axis size (pad upstream with
NaN observations — NaN steps are exact no-ops in the element algebra).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parallel_gps_tpu.kalman.parallel import (
    FilteringElement,
    SmoothingElement,
    filtering_identity as _filtering_identity_impl,
    filtering_operator,
    make_filtering_elements,
    make_smoothing_elements,
    smoothing_identity as _smoothing_identity_impl,
    smoothing_operator,
    _mv,
)
from parallel_gps_tpu.ops.linalg import mm, mvn_logpdf
from parallel_gps_tpu.parallel.scan import (
    sharded_associative_scan,
    sharded_associative_scan_tl,
)
from parallel_gps_tpu.types import LGSSM

try:  # JAX ≥ 0.6 stable API
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover - older JAX
    from jax.experimental.shard_map import shard_map


def make_time_mesh(n_devices: int | None = None, axis: str = "time") -> Mesh:
    """1-D mesh over all (or the first n) devices, named ``axis``."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


# Re-exported element identities (defined next to their operators).
_filtering_identity = _filtering_identity_impl
_smoothing_identity = _smoothing_identity_impl


def _scan_sharded(operator, elems, identity, mesh, axis: str, reverse: bool):
    spec = jax.tree.map(lambda _: P(axis), elems)
    fn = shard_map(
        partial(
            sharded_associative_scan,
            operator,
            axis_name=axis,
            identity=identity,
            reverse=reverse,
        ),
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
    )
    return fn(elems)


def sharded_pkf(
    lgssm: LGSSM,
    observations: Array,
    mesh: Mesh,
    axis: str = "time",
    return_loglikelihood: bool = False,
):
    """Parallel Kalman filter with the scan sharded over ``mesh[axis]``.

    Same semantics as :func:`parallel_gps_tpu.kalman.parallel.pkf`.
    """
    P0, Fs, Qs, H, R = lgssm
    d = P0.shape[0]
    dtype = P0.dtype
    m0 = jnp.zeros((d,), dtype)

    elems = make_filtering_elements(lgssm, observations)
    final = _scan_sharded(
        filtering_operator,
        elems,
        _filtering_identity(d, dtype),
        mesh,
        axis,
        reverse=False,
    )
    fms, fPs = final.b, final.C
    if not return_loglikelihood:
        return fms, fPs

    ys = observations.reshape(-1, 1)
    mask = jnp.logical_not(jnp.isnan(ys[:, 0]))
    y = jnp.where(mask[:, None], jnp.nan_to_num(ys), 0.0)
    prev_ms = jnp.concatenate([m0[None], fms[:-1]], axis=0)
    prev_Ps = jnp.concatenate([P0[None], fPs[:-1]], axis=0)
    mps = _mv(Fs, prev_ms)
    Pps = mm(mm(Fs, prev_Ps), jnp.swapaxes(Fs, -1, -2)) + Qs
    obs_means = _mv(H[None], mps)
    obs_covs = mm(mm(H[None], Pps), H.T) + R
    logprobs = mvn_logpdf(y, obs_means, obs_covs)
    ell = jnp.sum(jnp.where(mask, logprobs, 0.0))
    return fms, fPs, ell


def sharded_pks(
    lgssm: LGSSM, ms: Array, Ps: Array, mesh: Mesh, axis: str = "time"
):
    """Parallel RTS smoother with the reverse scan sharded over ``mesh[axis]``."""
    d = lgssm.P0.shape[0]
    elems = make_smoothing_elements(lgssm, ms, Ps)
    final = _scan_sharded(
        smoothing_operator,
        elems,
        _smoothing_identity(d, lgssm.P0.dtype),
        mesh,
        axis,
        reverse=True,
    )
    return final.g, final.L


def sharded_pkfs(
    lgssm: LGSSM, observations: Array, mesh: Mesh, axis: str = "time"
):
    fms, fPs = sharded_pkf(lgssm, observations, mesh, axis)
    return sharded_pks(lgssm, fms, fPs, mesh, axis)


def time_sharding(mesh: Mesh, axis: str = "time") -> NamedSharding:
    """Sharding for (T, ...) arrays: leading axis over the time mesh axis."""
    return NamedSharding(mesh, P(axis))


def make_mesh_2d(
    n_devices: int | None = None,
    batch: int = 1,
    batch_axis: str = "batch",
    time_axis: str = "time",
) -> Mesh:
    """2-D (batch × time) mesh: data parallelism over independent GPs on
    ``batch_axis``, sequence parallelism over the time axis on ``time_axis``."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    return Mesh(
        np.asarray(devs).reshape(batch, n // batch),
        (batch_axis, time_axis),
    )


def _scan_sharded_batched(
    operator, elems, identity, mesh, batch_axis: str, time_axis: str, reverse: bool
):
    """Associative scan over axis 1 (time) of elements with a leading batch
    axis; batch sharded over ``batch_axis``, time over ``time_axis``."""
    spec = jax.tree.map(lambda _: P(batch_axis, time_axis), elems)

    def local(e):
        return jax.vmap(
            lambda ee: sharded_associative_scan(
                operator,
                ee,
                axis_name=time_axis,
                identity=identity,
                reverse=reverse,
            )
        )(e)

    fn = shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec)
    return fn(elems)


def sharded_batched_pkf_lml(
    lgssm: LGSSM,
    observations: Array,
    mesh: Mesh,
    batch_axis: str = "batch",
    time_axis: str = "time",
) -> Array:
    """Log marginal likelihoods of a batch of independent GPs sharing one
    LGSSM: observations (B, T, 1) sharded (batch, time); returns (B,) ells.

    The dp×sp composition of BASELINE.json config 5: element construction is
    plain vectorized work GSPMD splits along both axes; the scans run through
    the two-level distributed scan with collectives over ``time_axis`` only.
    """
    P0, Fs, Qs, H, R = lgssm
    d = P0.shape[0]
    dtype = P0.dtype
    m0 = jnp.zeros((d,), dtype)

    elems = jax.vmap(lambda y: make_filtering_elements(lgssm, y))(observations)
    final = _scan_sharded_batched(
        filtering_operator,
        elems,
        _filtering_identity(d, dtype),
        mesh,
        batch_axis,
        time_axis,
        reverse=False,
    )
    fms, fPs = final.b, final.C  # (B, T, d), (B, T, d, d)

    ys = observations[..., 0]  # (B, T)
    mask = jnp.logical_not(jnp.isnan(ys))
    y = jnp.where(mask[..., None], jnp.nan_to_num(observations), 0.0)
    B = ys.shape[0]
    prev_ms = jnp.concatenate(
        [jnp.broadcast_to(m0, (B, 1, d)), fms[:, :-1]], axis=1
    )
    prev_Ps = jnp.concatenate(
        [jnp.broadcast_to(P0, (B, 1, d, d)), fPs[:, :-1]], axis=1
    )
    mps = _mv(Fs[None], prev_ms)
    Pps = mm(mm(Fs[None], prev_Ps), jnp.swapaxes(Fs, -1, -2)[None]) + Qs[None]
    obs_means = _mv(H[None, None], mps)
    obs_covs = mm(mm(H[None, None], Pps), H.T) + R
    logprobs = mvn_logpdf(y, obs_means, obs_covs)
    return jnp.sum(jnp.where(mask, logprobs, 0.0), axis=1)


# --------------------------------------------------------------------------
# Time-last (LGSSMTL) sharded engines: the fast-path layout per shard.
#
# The generic engines above shard (T, d, d) elements, whose combines are
# batches of tiny matrix products (see kalman/timelast.py).  These run the
# SAME two-level distributed scan but with time-last planes, so each
# shard's local scan is the single-device fast path.  Element
# construction and the log-likelihood stay OUTSIDE shard_map — they are
# elementwise, so GSPMD partitions them from the sharding annotations (the
# one-step shift in the likelihood becomes a collective-permute).
# --------------------------------------------------------------------------


def _tl_specs(tree_example, axis: str):
    return jax.tree.map(
        lambda x: P(*([None] * (x.ndim - 1) + [axis])), tree_example
    )


def sharded_pkf_tl(
    lgssm_tl,
    observations: Array,
    mesh: Mesh,
    axis: str = "time",
    return_loglikelihood: bool = False,
):
    """Time-axis-sharded parallel Kalman filter on an LGSSMTL.

    Returns time-last moments (b (d, T), C (d, d, T)[, ell]); T must be
    divisible by the mesh axis size (pad with NaN observations upstream).
    Differentiable end-to-end.
    """
    from parallel_gps_tpu.kalman.timelast import (
        _filtering_elements_from_planes,
        _loglik_from_planes,
        filtering_identity_tl,
        filtering_operator_tl,
    )

    P0, Fs, Qs, H, R = lgssm_tl
    d = P0.shape[0]
    elems = _filtering_elements_from_planes(P0, Fs, Qs, H, R, observations)
    spec = _tl_specs(elems, axis)
    fn = shard_map(
        partial(
            sharded_associative_scan_tl,
            filtering_operator_tl,
            axis_name=axis,
            identity=filtering_identity_tl(d, P0.dtype),
            reverse=False,
        ),
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
    )
    final = fn(elems)
    b_tl, C_tl = final.b, final.C
    if not return_loglikelihood:
        return b_tl, C_tl
    ell = _loglik_from_planes(P0, Fs, Qs, H, R, b_tl, C_tl, observations)
    return b_tl, C_tl, ell


def sharded_pks_tl(
    lgssm_tl, b_tl: Array, C_tl: Array, mesh: Mesh, axis: str = "time"
):
    """Time-axis-sharded parallel RTS smoother on time-last moments."""
    from parallel_gps_tpu.kalman.timelast import (
        _smoothing_elements_from_planes,
        smoothing_identity_tl,
        smoothing_operator_tl,
    )

    P0, Fs, Qs, _, _ = lgssm_tl
    d = P0.shape[0]
    elems = _smoothing_elements_from_planes(Fs, Qs, b_tl, C_tl)
    spec = _tl_specs(elems, axis)
    fn = shard_map(
        partial(
            sharded_associative_scan_tl,
            smoothing_operator_tl,
            axis_name=axis,
            identity=smoothing_identity_tl(d, P0.dtype),
            reverse=True,
        ),
        mesh=mesh,
        in_specs=(spec,),
        out_specs=spec,
    )
    final = fn(elems)
    return final.g, final.L


def sharded_pkfs_tl(
    lgssm_tl, observations: Array, mesh: Mesh, axis: str = "time"
):
    """Sharded filter + smoother on an LGSSMTL; returns time-last (g, L)."""
    b_tl, C_tl = sharded_pkf_tl(lgssm_tl, observations, mesh, axis)
    return sharded_pks_tl(lgssm_tl, b_tl, C_tl, mesh, axis)


# --------------------------------------------------------------------------
# Sharded LML with Fisher-identity gradients: the distributed counterpart of
# kalman.timelast.lml_tl.  Forward = sharded filter; backward = ONE sharded
# smoother pass + the elementwise Fisher formulas
# (kalman/timelast.py::fisher_grads_from_smoothed), which GSPMD partitions
# from the operand shardings — instead of replaying ~log2(T) Kogge-Stone
# passes through autodiff.
# --------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def sharded_lml_tl(lgssm_tl, observations: Array, mesh: Mesh, axis: str = "time"):
    """Log marginal likelihood of a time-axis-sharded LGSSMTL (scalar,
    replicated).  Differentiable w.r.t. (lgssm_tl, observations) via the
    Fisher identity."""
    _, _, ell = sharded_pkf_tl(
        lgssm_tl, observations, mesh, axis, return_loglikelihood=True
    )
    return ell


def _sharded_lml_fwd(lgssm_tl, observations, mesh, axis):
    b_tl, C_tl, ell = sharded_pkf_tl(
        lgssm_tl, observations, mesh, axis, return_loglikelihood=True
    )
    return ell, (lgssm_tl, observations, b_tl, C_tl)


def _sharded_lml_bwd(mesh, axis, residuals, gbar):
    from parallel_gps_tpu.kalman.timelast import fisher_grads_from_smoothed

    lgssm_tl, observations, b_tl, C_tl = residuals
    mhat, Phat = sharded_pks_tl(lgssm_tl, b_tl, C_tl, mesh, axis)
    return fisher_grads_from_smoothed(
        lgssm_tl, observations, b_tl, C_tl, mhat, Phat, gbar
    )


sharded_lml_tl.defvjp(_sharded_lml_fwd, _sharded_lml_bwd)


def sharded_batched_lml_tl(
    lgssm_tl_b,
    observations_b: Array,
    mesh: Mesh,
    batch_axis: str = "batch",
    time_axis: str = "time",
) -> Array:
    """LMLs of a batch of independent GPs on the time-last fast path,
    dp × sp over a 2-D mesh: batch of models over ``batch_axis``, the time
    axis of every plane over ``time_axis``.

    ``lgssm_tl_b`` leaves carry a leading batch axis — P0 (B, d, d),
    Fs/Qs (B, d, d, T), H (B, 1, d), R (B, 1, 1) (``jax.vmap(get_ssm_tl)``
    output); ``observations_b`` is (B, T).  Returns (B,) log-likelihoods.

    This is the distributed composition of BASELINE.json config 5 on the
    time-last layout: per-shard local time-last scans, one tiny all_gather
    of boundary elements over ``time_axis`` per scan, batch embarrassingly
    parallel over ``batch_axis``.
    """
    from parallel_gps_tpu.kalman.timelast import (
        _filtering_elements_from_planes,
        _loglik_from_planes,
        filtering_identity_tl,
        filtering_operator_tl,
    )

    P0_b, Fs_b, Qs_b, H_b, R_b = lgssm_tl_b
    d = P0_b.shape[-1]
    dtype = P0_b.dtype
    ys_b = observations_b.reshape(observations_b.shape[0], -1)

    elems = jax.vmap(_filtering_elements_from_planes)(
        P0_b, Fs_b, Qs_b, H_b, R_b, ys_b
    )  # leaves (B, d[, d], T)
    spec = jax.tree.map(
        lambda x: P(batch_axis, *([None] * (x.ndim - 2)), time_axis), elems
    )

    def local(e):
        return jax.vmap(
            lambda ee: sharded_associative_scan_tl(
                filtering_operator_tl,
                ee,
                axis_name=time_axis,
                identity=filtering_identity_tl(d, dtype),
                reverse=False,
            )
        )(e)

    final = shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=spec)(
        elems
    )
    return jax.vmap(_loglik_from_planes)(
        P0_b, Fs_b, Qs_b, H_b, R_b, final.b, final.C, ys_b
    )
