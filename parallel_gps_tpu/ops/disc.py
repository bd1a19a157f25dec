"""Continuous → discrete compilation: LTI SDE + time stamps → LGSSM.

The reference discretizes with a batched 2d×2d matrix exponential via the
matrix-fraction decomposition (reference: pssgp/kernels/base.py:29-47).  Every
kernel in this framework (as in the reference) sets P0 to the *stationary*
covariance P∞ solving F P + P Fᵀ + L Q Lᵀ = 0, in which case the discrete
process noise has the closed form

    Q_k = P∞ − A_k P∞ A_kᵀ,   A_k = expm(dt_k · F),

which needs only the d×d exponential — half the FLOPs and better
conditioned.  ``discretize`` uses this identity; ``discretize_mfd`` keeps the
general matrix-fraction path as a cross-checked oracle (tests assert the two
agree for every kernel).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu.ops.expm import expm1_dt_batched, expm1_dt_tl, expm_pade13
from parallel_gps_tpu.ops.linalg import mm, symmetrize
from parallel_gps_tpu.types import LGSSM, LGSSMTL, ContinuousDiscreteModel


def _dts(ts: Array, t0) -> Array:
    """Time deltas with t0 prepended (reference: pssgp/kernels/base.py:32-35)."""
    ts = ts.reshape(-1)
    t0 = jnp.asarray(t0, dtype=ts.dtype).reshape(())
    prev = jnp.concatenate([t0[None], ts[:-1]])
    return ts - prev


def discretize(
    sde: ContinuousDiscreteModel,
    ts: Array,
    R: Array,
    t0=0.0,
    transitions_m1=None,
) -> LGSSM:
    """Stationary-initialization discretization (see module docstring).

    ``transitions_m1``: optional callable ``dts -> (T, d, d)`` supplying the
    cancellation-free ``expm(dt_k F) − I`` (kernels with analytic transition
    operators provide this — Matérn nilpotent/expm1 forms, Periodic
    half-angle rotations); defaults to the batched Padé-13 expm1 path.

    Given Am1 = A − I the process noise is computed as

        Q = P − A P Aᵀ = −(Am1·P + P·Am1ᵀ + Am1·P·Am1ᵀ),

    every term O(dt) with full relative precision — the naive P − A P Aᵀ
    loses eps/dt relative accuracy and (in float32 at dt ~ 1e−6) destroys
    positive-definiteness, which is exactly the large-T float32 instability
    the reference accepts (SURVEY.md §6 stability sweeps) and this form
    removes.
    """
    dts = _dts(ts, t0)
    if transitions_m1 is not None:
        Am1 = transitions_m1(dts)
    else:
        Am1 = expm1_dt_batched(sde.F, dts)
    d = sde.F.shape[0]
    Fs = Am1 + jnp.eye(d, dtype=Am1.dtype)
    P0 = symmetrize(sde.P0)
    AP = mm(Am1, P0)
    Qs = symmetrize(
        -(AP + jnp.swapaxes(AP, -1, -2) + mm(AP, jnp.swapaxes(Am1, -1, -2)))
    )
    return LGSSM(P0, Fs, Qs, sde.H, jnp.asarray(R).reshape(1, 1))


def discretize_tl(
    sde: ContinuousDiscreteModel,
    ts: Array,
    R: Array,
    t0=0.0,
    transitions_m1_tl=None,
) -> LGSSMTL:
    """Time-last discretization: identical math to :func:`discretize` but
    producing (d, d, T) transition/noise stacks with NO (T, d, d) relayout.

    ``transitions_m1_tl``: callable ``dts -> (d, d, T)`` supplying
    ``expm(dt_k F) − I`` time-last; kernels with closed forms build this
    directly from (T,) lane planes (free — pure broadcasts).  Falls back to
    the time-last Padé path (``expm1_dt_tl`` — the batched (T, d, d) layout
    pads tiny matrices to register tiles, a 28× memory expansion that OOMs
    high-order kernels at large T).
    """
    dts = _dts(ts, t0)
    if transitions_m1_tl is not None:
        Am1 = transitions_m1_tl(dts)  # (d, d, T)
    else:
        Am1 = expm1_dt_tl(sde.F, dts)
    d = sde.F.shape[0]
    T = dts.shape[0]
    P0 = symmetrize(sde.P0)
    eye_tl = jnp.broadcast_to(jnp.eye(d, dtype=Am1.dtype)[:, :, None], (d, d, T))
    Fs = Am1 + eye_tl
    # Time-last small-matrix products: out[i,j,t] = Σ_k a[i,k,t]·b[k,j,t].
    P0_tl = P0[:, :, None]
    AP = jnp.sum(Am1[:, :, None, :] * P0_tl[None, :, :, :], axis=1)  # (d,d,T)
    APAt = jnp.sum(AP[:, :, None, :] * Am1[None, :, :, :].swapaxes(1, 2), axis=1)
    Q = -(AP + jnp.swapaxes(AP, 0, 1) + APAt)
    Qs = 0.5 * (Q + jnp.swapaxes(Q, 0, 1))
    return LGSSMTL(P0, Fs, Qs, sde.H, jnp.asarray(R).reshape(1, 1))


def discretize_mfd(
    sde: ContinuousDiscreteModel, ts: Array, R: Array, t0=0.0
) -> LGSSM:
    """Matrix-fraction-decomposition discretization.

    General path valid for any P0 (not only stationary); mirrors the math of
    reference pssgp/kernels/base.py:36-46 with a single fused 2d×2d expm.
    """
    n = sde.F.shape[0]
    dts = _dts(ts, t0)

    LQL = mm(mm(sde.L, sde.Q), sde.L.T)
    Phi = jnp.block([[sde.F, LQL], [jnp.zeros_like(sde.F), -sde.F.T]])

    M = expm_pade13(dts[:, None, None] * Phi[None])
    Fs = M[:, :n, :n]  # block-triangular structure: equals expm(dt F)
    Qs = mm(M[:, :n, n:], jnp.swapaxes(Fs, -1, -2))
    return LGSSM(sde.P0, Fs, symmetrize(Qs), sde.H, jnp.asarray(R).reshape(1, 1))
