"""Sequential Kalman filter / RTS smoother — the O(T)-span oracle engine.

Semantics mirror the reference (pssgp/kalman/sequential.py): zero initial
mean, per-step symmetrization, NaN observations skip the update step, and the
log-marginal-likelihood accumulates per-step innovation log-densities.

Differences from the reference:
  - ``jax.lax.scan`` instead of ``tf.scan``;
  - NaN handling by masked ``where``-selection instead of ``tf.cond``
    (branchless → no divergent control flow inside the compiled loop, and
    NaNs are scrubbed before arithmetic so reverse-mode AD stays NaN-free);
  - every matrix product runs at full float32 precision (``ops.linalg.mm``)
    — this engine is the oracle, so it must not take the TF32 matmul mode
    a GPU may use for float32 by default.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu.ops.linalg import cho_solve_psd, mm, mvn_logpdf, symmetrize
from parallel_gps_tpu.types import LGSSM


class _FilterResult(NamedTuple):
    ell: Array
    fms: Array
    fPs: Array
    mps: Array
    Pps: Array


def _filter_all(lgssm: LGSSM, observations: Array) -> _FilterResult:
    P0, Fs, Qs, H, R = lgssm
    dtype = P0.dtype
    d = P0.shape[0]
    m0 = jnp.zeros((d,), dtype)

    # Observations are (T,) / (T, 1) scalars in every reference experiment,
    # but the textbook recursions below are written for general m-dim
    # observations (H (m, d), R (m, m), ys (T, m)) like the reference's
    # (pssgp/kalman/sequential.py:26-32).  A step with ANY NaN component is
    # treated as fully missing (the reference only ever encodes scalar NaNs).
    ys = observations.reshape(Fs.shape[0], H.shape[0])
    mask = jnp.logical_not(jnp.any(jnp.isnan(ys), axis=-1))
    ys_safe = jnp.where(mask[:, None], jnp.nan_to_num(ys), 0.0)

    def body(carry, inp):
        ell, m, P = carry
        y, F, Q, ok = inp

        mp = mm(F, m)
        Pp = symmetrize(mm(mm(F, P), F.T) + Q)

        S = mm(mm(H, Pp), H.T) + R  # (m, m)
        yp = mm(H, mp)  # (1,)
        ell_t = mvn_logpdf(y, yp, S)
        Kt = cho_solve_psd(S, mm(H, Pp))  # (1, d)

        m_upd = mp + mm(Kt.T, y - yp)
        P_upd = Pp - mm(mm(Kt.T, S), Kt)

        m = jnp.where(ok, m_upd, mp)
        P = symmetrize(jnp.where(ok, P_upd, Pp))
        ell = ell + jnp.where(ok, ell_t, 0.0)
        return (ell, m, P), (m, P, mp, Pp)

    (ell, _, _), (fms, fPs, mps, Pps) = jax.lax.scan(
        body,
        (jnp.zeros((), dtype), m0, P0),
        (ys_safe, Fs, Qs, mask),
    )
    return _FilterResult(ell, fms, fPs, mps, Pps)


def kf(
    lgssm: LGSSM,
    observations: Array,
    return_loglikelihood: bool = False,
    return_predicted: bool = False,
):
    """Kalman filter (reference API: pssgp/kalman/sequential.py:11-47)."""
    res = _filter_all(lgssm, observations)
    out = (res.fms, res.fPs)
    if return_loglikelihood:
        out = out + (res.ell,)
    if return_predicted:
        out = out + (res.mps, res.Pps)
    return out


def ks(lgssm: LGSSM, ms: Array, Ps: Array, mps: Array, Pps: Array):
    """RTS smoother (reference: pssgp/kalman/sequential.py:50-68)."""
    _, Fs, Qs, *_ = lgssm

    def body(carry, inp):
        F, Q, m, P, mp, Pp = inp
        sm, sP = carry
        Ct = cho_solve_psd(Pp, mm(F, P))  # (d, d)
        sm = m + mm(Ct.T, sm - mp)
        sP = symmetrize(P + mm(mm(Ct.T, sP - Pp), Ct))
        return (sm, sP), (sm, sP)

    (_, _), (sms, sPs) = jax.lax.scan(
        body,
        (ms[-1], Ps[-1]),
        (Fs[1:], Qs[1:], ms[:-1], Ps[:-1], mps[1:], Pps[1:]),
        reverse=True,
    )
    sms = jnp.concatenate([sms, ms[-1][None]], axis=0)
    sPs = jnp.concatenate([sPs, Ps[-1][None]], axis=0)
    return sms, sPs


def kfs(lgssm: LGSSM, observations: Array):
    """Filter + smoother (reference: pssgp/kalman/sequential.py:71-73)."""
    fms, fPs, mps, Pps = kf(lgssm, observations, return_predicted=True)
    return ks(lgssm, fms, fPs, mps, Pps)
