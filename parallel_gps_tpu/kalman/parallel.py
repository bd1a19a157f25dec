"""Parallel Kalman filter / smoother via associative scan — O(log T) span.

Implements the filtering/smoothing element algebra of Särkkä &
García-Fernández, "Temporal Parallelization of Bayesian Smoothers"
(arXiv 1905.13002), matching the reference semantics
(pssgp/kalman/parallel.py):

  - ``jax.lax.associative_scan`` (XLA-compiled Blelloch tree) instead of
    TFP's ``scan_associative``; no ``max_num_levels`` knob is needed — the
    tree depth is ceil(log2(T)) by construction.  ``max_parallel`` is kept in
    the public API for compatibility and ignored.
  - NaN-as-missing handled by vectorized masked selection (reference:
    parallel.py:46-53,83-97), with NaNs scrubbed before arithmetic so
    reverse-mode AD is NaN-free.
  - All element construction and the log-likelihood are single vectorized
    passes over T (reference: parallel.py:135-151).
  - Matrix products run at full float32 precision (``ops.linalg.mm``), so
    this generic engine stays a faithful oracle on GPUs, whose default
    float32 matmul may use TF32.

Element types:
  filtering: (A, b, C, J, eta) per reference parallel.py:13-118;
  smoothing:  (E, g, L)        per reference parallel.py:155-184.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu.ops.linalg import mm, mvn_logpdf, solve_small, symmetrize
from parallel_gps_tpu.ops.scan import blocked_associative_scan
from parallel_gps_tpu.types import LGSSM, LGSSMTL


class FilteringElement(NamedTuple):
    A: Array  # (..., d, d)
    b: Array  # (..., d)
    C: Array  # (..., d, d)
    J: Array  # (..., d, d)
    eta: Array  # (..., d)


class SmoothingElement(NamedTuple):
    E: Array  # (..., d, d)
    g: Array  # (..., d)
    L: Array  # (..., d, d)


def _mv(M: Array, v: Array) -> Array:
    return mm(M, v[..., None])[..., 0]


def filtering_identity(d: int, dtype) -> FilteringElement:
    """Identity of :func:`filtering_operator`: (A=I, b=0, C=0, J=0, eta=0)."""
    return FilteringElement(
        A=jnp.eye(d, dtype=dtype),
        b=jnp.zeros((d,), dtype),
        C=jnp.zeros((d, d), dtype),
        J=jnp.zeros((d, d), dtype),
        eta=jnp.zeros((d,), dtype),
    )


def smoothing_identity(d: int, dtype) -> SmoothingElement:
    """Identity of :func:`smoothing_operator`: (E=I, g=0, L=0)."""
    return SmoothingElement(
        E=jnp.eye(d, dtype=dtype),
        g=jnp.zeros((d,), dtype),
        L=jnp.zeros((d, d), dtype),
    )


def make_filtering_elements(
    lgssm: LGSSM, observations: Array
) -> FilteringElement:
    """Build per-step filtering elements, vectorized over T
    (reference: pssgp/kalman/parallel.py:13-97)."""
    P0, Fs, Qs, H, R = lgssm
    dtype = P0.dtype
    d = P0.shape[0]
    T = Fs.shape[0]
    m0 = jnp.zeros((d,), dtype)

    # Written for general m-dim observations (H (m, d), R (m, m), ys (T, m))
    # with (m, m) solves exactly as the reference algebra is stated
    # (pssgp/kalman/parallel.py:26-33,56-72); every reference experiment and
    # the TL/Pallas fast paths use m = 1 (see types.LGSSM).  A step with ANY
    # NaN component is treated as fully missing.
    ys = observations.reshape(T, H.shape[0])
    mask = jnp.logical_not(jnp.any(jnp.isnan(ys), axis=-1))  # (T,)
    y = jnp.where(mask[:, None], jnp.nan_to_num(ys), 0.0)  # (T, m)

    # --- generic elements, all steps at once -------------------------------
    HQ = mm(H[None], Qs)  # (T, m, d)
    S = mm(HQ, H.T) + R  # (T, m, m) innovation covariance
    Kt = solve_small(S, HQ)  # (T, m, d) == S⁻¹ H Q
    HF = mm(H[None], Fs)  # (T, m, d)

    A_ok = Fs - mm(jnp.swapaxes(Kt, -1, -2), HF)  # (I - Kᵀ H) F
    b_ok = _mv(jnp.swapaxes(Kt, -1, -2), y)  # (T, d)
    C_ok = Qs - mm(jnp.swapaxes(Kt, -1, -2), HQ)
    eta_ok = _mv(jnp.swapaxes(HF, -1, -2), solve_small(S, y[..., None])[..., 0])
    J_ok = mm(jnp.swapaxes(HF, -1, -2), solve_small(S, HF))  # (T, d, d)

    # NaN (missing-observation) variant: pure prediction
    # (reference: parallel.py:46-53).
    m3 = mask[:, None, None]
    m2 = mask[:, None]
    A = jnp.where(m3, A_ok, Fs)
    b = jnp.where(m2, b_ok, 0.0)
    C = jnp.where(m3, C_ok, Qs)
    eta = jnp.where(m2, eta_ok, 0.0)
    J = jnp.where(m3, J_ok, 0.0)

    # --- first element: filter step against (m0, P0) -----------------------
    # (reference: parallel.py:13-43)
    S1 = mm(mm(H, P0), H.T) + R  # (m, m)
    K1t = solve_small(S1, mm(H, P0))  # (m, d)
    b0_ok = m0 + _mv(K1t.T, y[0] - _mv(H, m0))
    C0_ok = P0 - mm(mm(K1t.T, S1), K1t)
    S0 = mm(mm(H, Qs[0]), H.T) + R
    HF0 = mm(H, Fs[0])
    eta0_ok = mm(HF0.T, solve_small(S0, y[0][:, None]))[:, 0]
    J0_ok = mm(HF0.T, solve_small(S0, HF0))

    ok0 = mask[0]
    A0 = jnp.zeros((d, d), dtype)
    b0 = jnp.where(ok0, b0_ok, m0)
    C0 = jnp.where(ok0, C0_ok, P0)
    eta0 = jnp.where(ok0, eta0_ok, 0.0)
    J0 = jnp.where(ok0, J0_ok, 0.0)

    return FilteringElement(
        A=A.at[0].set(A0),
        b=b.at[0].set(b0),
        C=C.at[0].set(C0),
        J=J.at[0].set(J0),
        eta=eta.at[0].set(eta0),
    )


def filtering_operator(
    elem1: FilteringElement, elem2: FilteringElement
) -> FilteringElement:
    """Associative combine of filtering elements (Lemma 7/8 of arXiv
    1905.13002; reference: pssgp/kalman/parallel.py:100-118).

    Batched over arbitrary leading dimensions.
    """
    A1, b1, C1, J1, eta1 = elem1
    A2, b2, C2, J2, eta2 = elem2
    d = A1.shape[-1]
    I = jnp.eye(d, dtype=A1.dtype)

    # U = A2 (I + C1 J2)⁻¹, via the transposed solve.
    M1 = I + mm(C1, J2)
    U = jnp.swapaxes(
        solve_small(jnp.swapaxes(M1, -1, -2), jnp.swapaxes(A2, -1, -2)),
        -1,
        -2,
    )
    A = mm(U, A1)
    b = _mv(U, b1 + _mv(C1, eta2)) + b2
    C = mm(mm(U, C1), jnp.swapaxes(A2, -1, -2)) + C2

    # V = (I + J2 C1)⁻ᵀ A1, i.e. Vᵀ = A1ᵀ (I + J2 C1)⁻¹.
    M2 = I + mm(J2, C1)
    V = solve_small(jnp.swapaxes(M2, -1, -2), A1)
    eta = _mv(jnp.swapaxes(V, -1, -2), eta2 - _mv(J2, b1)) + eta1
    J = mm(mm(jnp.swapaxes(V, -1, -2), J2), A1) + J1

    return FilteringElement(
        A=A, b=b, C=symmetrize(C), J=symmetrize(J), eta=eta
    )


_ENGINES = ("auto", "timelast", "generic")


def _use_timelast(lgssm, engine: str) -> bool:
    """Resolve ``engine`` for one call: True → time-last, False → generic.

    An LGSSMTL input always takes the time-last engine (it covers every
    state dim through Schur-recursed inverses).  Explicit requests that the
    chosen path cannot honour raise instead of silently downgrading."""
    if engine not in _ENGINES:
        raise ValueError(f"engine must be one of {_ENGINES}, got {engine!r}")
    if isinstance(lgssm, LGSSMTL):
        if engine == "generic":
            raise ValueError(
                "engine='generic' (the reference-literal oracle) operates on"
                " the LGSSM (time-first) layout only; convert explicitly, e.g."
                " LGSSM(P0, moveaxis(Fs, -1, 0), moveaxis(Qs, -1, 0), H, R)"
            )
        return True
    if lgssm.H.shape[0] > 1:
        # Multi-dim observations (m > 1): only the generic engine carries
        # the (m, m)-solve algebra; the time-last engine is scalar-
        # observation specialized (see types.LGSSM).
        if engine == "timelast":
            raise ValueError(
                f"engine={engine!r} supports scalar observations only"
                f" (H has {lgssm.H.shape[0]} rows); use engine='generic'"
            )
        return False
    if engine == "timelast":
        return True
    if engine == "generic":
        return False
    # auto on the time-first layout: time-last for d ≤ 3 (closed-form
    # inverses), generic layout for larger state dims.
    return lgssm.P0.shape[0] <= 3


def pkf(
    lgssm: LGSSM,
    observations: Array,
    return_loglikelihood: bool = False,
    max_parallel: int = 0,
    engine: str = "auto",
):
    """Parallel Kalman filter (reference API: pssgp/kalman/parallel.py:121-152).

    ``max_parallel`` is accepted for reference-API compatibility and ignored
    (see module docstring).  ``engine``: "auto" (time-last fast path for
    d ≤ 3, else generic), "timelast", or "generic".

    Accepts either layout: an ``LGSSM`` (time-first, the reference layout)
    or an ``LGSSMTL`` (time-last, from ``SDEKernel.get_ssm_tl`` — zero
    relayouts until the returned moments).
    """
    del max_parallel
    if isinstance(lgssm, LGSSMTL) and _use_timelast(lgssm, engine):
        from parallel_gps_tpu.kalman.timelast import pkf_from_tl

        out = pkf_from_tl(lgssm, observations, return_loglikelihood)
        # Convert moments to the reference (T, d) layout; under jit the
        # conversion is dead-code-eliminated when callers only use ell.
        moments = tuple(jnp.moveaxis(x, -1, 0) for x in out[:2])
        return moments + tuple(out[2:])
    if _use_timelast(lgssm, engine):
        from parallel_gps_tpu.kalman.timelast import pkf_tl

        return pkf_tl(lgssm, observations, return_loglikelihood)
    P0, Fs, Qs, H, R = lgssm
    dtype = P0.dtype
    d = P0.shape[0]
    m0 = jnp.zeros((d,), dtype)

    elems = make_filtering_elements(lgssm, observations)
    final = blocked_associative_scan(
        filtering_operator, elems, filtering_identity(d, dtype)
    )
    fms, fPs = final.b, final.C

    if not return_loglikelihood:
        return fms, fPs

    # Post-hoc vectorized log-likelihood (reference: parallel.py:135-151).
    ys = observations.reshape(-1, H.shape[0])
    mask = jnp.logical_not(jnp.any(jnp.isnan(ys), axis=-1))
    y = jnp.where(mask[:, None], jnp.nan_to_num(ys), 0.0)

    prev_ms = jnp.concatenate([m0[None], fms[:-1]], axis=0)
    prev_Ps = jnp.concatenate([P0[None], fPs[:-1]], axis=0)
    mps = _mv(Fs, prev_ms)
    Pps = mm(mm(Fs, prev_Ps), jnp.swapaxes(Fs, -1, -2)) + Qs
    obs_means = _mv(H[None], mps)  # (T, 1)
    obs_covs = mm(mm(H[None], Pps), H.T) + R  # (T, 1, 1)
    logprobs = mvn_logpdf(y, obs_means, obs_covs)
    ell = jnp.sum(jnp.where(mask, logprobs, 0.0))
    return fms, fPs, ell


def make_smoothing_elements(
    lgssm: LGSSM, ms: Array, Ps: Array
) -> SmoothingElement:
    """Per-step smoothing elements from filtered moments
    (reference: pssgp/kalman/parallel.py:155-173)."""
    _, Fs, Qs, *_ = lgssm

    F, Q = Fs[1:], Qs[1:]
    m, P = ms[:-1], Ps[:-1]
    Pp = mm(mm(F, P), jnp.swapaxes(F, -1, -2)) + Q
    FP = mm(F, P)
    # E = (Pp⁻¹ F P)ᵀ  via PSD solve.
    E = jnp.swapaxes(solve_small(symmetrize(Pp), FP), -1, -2)
    g = m - _mv(mm(E, F), m)
    L = symmetrize(P - mm(mm(E, Pp), jnp.swapaxes(E, -1, -2)))

    E_last = jnp.zeros_like(Ps[-1])
    return SmoothingElement(
        E=jnp.concatenate([E, E_last[None]], axis=0),
        g=jnp.concatenate([g, ms[-1][None]], axis=0),
        L=jnp.concatenate([L, Ps[-1][None]], axis=0),
    )


def smoothing_operator(
    elem1: SmoothingElement, elem2: SmoothingElement
) -> SmoothingElement:
    """Associative combine of smoothing elements
    (reference: pssgp/kalman/parallel.py:176-184)."""
    E1, g1, L1 = elem1
    E2, g2, L2 = elem2
    E = mm(E2, E1)
    g = _mv(E2, g1) + g2
    L = mm(mm(E2, L1), jnp.swapaxes(E2, -1, -2)) + L2
    return SmoothingElement(E=E, g=g, L=L)


def pks(
    lgssm: LGSSM,
    ms: Array,
    Ps: Array,
    max_parallel: int = 0,
    engine: str = "auto",
):
    """Parallel RTS smoother (reference: pssgp/kalman/parallel.py:187-196).

    Accepts LGSSM or LGSSMTL (``ms``/``Ps`` stay (T, d)/(T, d, d) in both
    cases — for a fully time-last pipeline use ``pkfs`` on the LGSSMTL or
    ``kalman.timelast.pks_from_tl`` directly)."""
    del max_parallel
    if isinstance(lgssm, LGSSMTL) and _use_timelast(lgssm, engine):
        from parallel_gps_tpu.kalman.timelast import pks_from_tl

        g_tl, L_tl = pks_from_tl(
            lgssm, jnp.moveaxis(ms, 0, -1), jnp.moveaxis(Ps, 0, -1)
        )
        return jnp.moveaxis(g_tl, -1, 0), jnp.moveaxis(L_tl, -1, 0)
    if _use_timelast(lgssm, engine):
        from parallel_gps_tpu.kalman.timelast import pks_tl

        return pks_tl(lgssm, ms, Ps)
    d = lgssm.P0.shape[0]
    elems = make_smoothing_elements(lgssm, ms, Ps)
    final = blocked_associative_scan(
        smoothing_operator,
        elems,
        smoothing_identity(d, lgssm.P0.dtype),
        reverse=True,
    )
    return final.g, final.L


def pkfs(
    lgssm: LGSSM,
    observations: Array,
    max_parallel: int = 0,
    engine: str = "auto",
):
    """Parallel filter + smoother (reference: pssgp/kalman/parallel.py:199-201).

    On an LGSSMTL input the filtered moments stay time-last between the two
    scans and only the final smoothed moments are converted to (T, d)."""
    if isinstance(lgssm, LGSSMTL) and _use_timelast(lgssm, engine):
        from parallel_gps_tpu.kalman.timelast import pkfs_from_tl

        return pkfs_from_tl(lgssm, observations)
    fms, fPs = pkf(lgssm, observations, False, engine=engine)
    return pks(lgssm, fms, fPs, engine=engine)
