"""Time-last (structure-of-arrays) parallel Kalman engine — the fast path.

The generic engine stores scan elements as (T, d, d) arrays, so every
combine is a batch of tiny (d, d) solves and matmuls that run far below the
device's bandwidth bound at d ≤ 3.

This engine keeps the SAME element algebra (reference:
pssgp/kalman/parallel.py:13-201) but lays every element component out
time-LAST — A as (d, d, T), b as (d, T) — so the time axis is the long,
contiguous one and every operation in the combine is a fused elementwise
multiply-add over (T,) planes:

  - d×d matmuls are unrolled broadcast-multiply-reduce over the tiny axes
    (no dot products, so no reduced-precision matmul modes apply);
  - the (I + C J)⁻¹ solves use closed-form adjugate inverses for d ≤ 3 and
    Schur-complement block recursion onto those base cases for d > 3 (see
    ``_inv``) — every state dimension in the framework (Matérn d ≤ 3, RBF
    order k, Periodic 2(N+1), the CO2 composite d = 18) runs elementwise;
  - the scan is Kogge-Stone over the time axis: log2(T) rounds of
    ``roll(+identity-mask)`` + combine, all elementwise — no strided
    dynamic slicing, no (T, d, d) relayouts.

Everything is plain differentiable JAX; ``jax.grad`` flows through rolls and
the adjugate formulas.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu.ops.linalg import mm
from parallel_gps_tpu.types import LGSSM


class FilteringElementTL(NamedTuple):
    A: Array  # (d, d, T)
    b: Array  # (d, T)
    C: Array  # (d, d, T)
    J: Array  # (d, d, T)
    eta: Array  # (d, T)


class SmoothingElementTL(NamedTuple):
    E: Array  # (d, d, T)
    g: Array  # (d, T)
    L: Array  # (d, d, T)


# --------------------------------------------------------------------------
# Time-last small-matrix algebra: everything elementwise over the last axis.
# --------------------------------------------------------------------------


def _mm(a: Array, b: Array) -> Array:
    """(d,d,T) @ (d,d,T) → (d,d,T): out[i,j] = Σ_k a[i,k]·b[k,j]."""
    return jnp.sum(a[:, :, None, :] * b[None, :, :, :], axis=1)


def _mv(a: Array, v: Array) -> Array:
    """(d,d,T) @ (d,T) → (d,T)."""
    return jnp.sum(a * v[None, :, :], axis=1)


def _mt(a: Array) -> Array:
    """Transpose over the matrix axes."""
    return jnp.swapaxes(a, 0, 1)


def _sym(a: Array) -> Array:
    return 0.5 * (a + _mt(a))


def _inv(M: Array) -> Array:
    """Inverse over (d, d, T) planes, elementwise in every trailing axis.

    d ≤ 3: closed-form adjugate.  d > 3: Schur-complement block recursion
    M = [[A, B], [C, D]] ⇒ blockwise inverse via A⁻¹ and the Schur
    complement S = D − C A⁻¹ B — every operation stays an elementwise
    multiply-add over the trailing (time/batch) axes, which is what keeps
    the time-last engine elementwise for high-order kernels (RBF order k,
    Periodic, the CO2 composite at d = 18) instead of falling back to the
    generic engine's batched tiny solves.

    Block stability: the engine inverts either SPD matrices (smoother
    predicted covariances) or I + C·J with C, J PSD (filter combine) whose
    spectrum lies right of 1; leading blocks are well-conditioned for these
    families (pinned against the dense-GP oracle in tests up to d = 18).
    """
    d = M.shape[0]
    if d > 3:
        k = (d + 1) // 2
        A, B = M[:k, :k], M[:k, k:]
        C, D = M[k:, :k], M[k:, k:]
        Ainv = _inv(A)
        CAinv = _mm(C, Ainv)  # (d-k, k, ...)
        AinvB = _mm(Ainv, B)  # (k, d-k, ...)
        S = D - _mm(CAinv, B)
        Sinv = _inv(S)
        TL = Ainv + _mm(_mm(AinvB, Sinv), CAinv)
        TR = -_mm(AinvB, Sinv)
        BL = -_mm(Sinv, CAinv)
        top = jnp.concatenate([TL, TR], axis=1)
        bot = jnp.concatenate([BL, Sinv], axis=1)
        return jnp.concatenate([top, bot], axis=0)
    if d == 1:
        return 1.0 / M
    if d == 2:
        a, b = M[0, 0], M[0, 1]
        c, e = M[1, 0], M[1, 1]
        det = a * e - b * c
        return jnp.stack(
            [jnp.stack([e, -b]), jnp.stack([-c, a])]
        ) / det
    if d == 3:
        a, b, c = M[0, 0], M[0, 1], M[0, 2]
        e, f, g = M[1, 0], M[1, 1], M[1, 2]
        h, i, j = M[2, 0], M[2, 1], M[2, 2]
        A00 = f * j - g * i
        A01 = c * i - b * j
        A02 = b * g - c * f
        A10 = g * h - e * j
        A11 = a * j - c * h
        A12 = c * e - a * g
        A20 = e * i - f * h
        A21 = b * h - a * i
        A22 = a * f - b * e
        det = a * A00 + b * A10 + c * A20
        adj = jnp.stack(
            [
                jnp.stack([A00, A01, A02]),
                jnp.stack([A10, A11, A12]),
                jnp.stack([A20, A21, A22]),
            ]
        )
        return adj / det
    raise AssertionError("unreachable: d > 3 handled by Schur recursion")


def _eye(d: int, T: int, dtype) -> Array:
    return jnp.broadcast_to(jnp.eye(d, dtype=dtype)[:, :, None], (d, d, T))


# --------------------------------------------------------------------------
# Element construction (same math as kalman.parallel.make_filtering_elements)
# --------------------------------------------------------------------------


def make_filtering_elements_tl(
    lgssm: LGSSM, observations: Array
) -> FilteringElementTL:
    P0, Fs, Qs, H, R = lgssm
    return _filtering_elements_from_planes(
        P0, jnp.moveaxis(Fs, 0, -1), jnp.moveaxis(Qs, 0, -1), H, R, observations
    )


def _filtering_elements_from_planes(
    P0: Array, A_std: Array, Q: Array, H: Array, R: Array, observations: Array
) -> FilteringElementTL:
    """Core element construction on time-last (d, d, T) planes — zero
    relayouts when fed from an LGSSMTL."""
    dtype = P0.dtype
    d = P0.shape[0]
    T = A_std.shape[-1]

    h = H[0]  # (d,)
    r = R[0, 0]

    ys = observations.reshape(T)
    mask = jnp.logical_not(jnp.isnan(ys))
    y = jnp.where(mask, jnp.nan_to_num(ys), 0.0)  # (T,)

    HQ = jnp.sum(h[:, None, None] * Q, axis=0)  # (d, T):  (HQ)_j
    S = jnp.sum(h[:, None] * HQ, axis=0) + r  # (T,)
    Sinv = 1.0 / S
    K = HQ * Sinv[None]  # (d, T) == (S⁻¹HQ)ᵀ rows
    HF = jnp.sum(h[:, None, None] * A_std, axis=0)  # (d, T)

    A_ok = A_std - K[:, None, :] * HF[None, :, :]
    b_ok = K * y[None]
    C_ok = Q - K[:, None, :] * HQ[None, :, :]
    eta_ok = HF * (Sinv * y)[None]
    J_ok = HF[:, None, :] * HF[None, :, :] * Sinv[None, None]

    m2 = mask[None]
    m3 = mask[None, None]
    A = jnp.where(m3, A_ok, A_std)
    b = jnp.where(m2, b_ok, 0.0)
    C = jnp.where(m3, C_ok, Q)
    eta = jnp.where(m2, eta_ok, 0.0)
    J = jnp.where(m3, J_ok, 0.0)

    # First element: filter step against (m0=0, P0)
    # (reference: parallel.py:13-43).
    P0h = mm(P0, h)  # (d,)
    S1 = jnp.sum(h * P0h) + r
    K1 = P0h / S1  # (d,)
    b0_ok = K1 * y[0]
    C0_ok = P0 - jnp.outer(K1, P0h)
    S0 = S[0]
    HF0 = HF[:, 0]
    eta0_ok = HF0 * (y[0] / S0)
    J0_ok = jnp.outer(HF0, HF0) / S0

    ok0 = mask[0]
    b0 = jnp.where(ok0, b0_ok, 0.0)
    C0 = jnp.where(ok0, C0_ok, P0)
    eta0 = jnp.where(ok0, eta0_ok, 0.0)
    J0 = jnp.where(ok0, J0_ok, jnp.zeros((d, d), dtype))

    return FilteringElementTL(
        A=A.at[:, :, 0].set(jnp.zeros((d, d), dtype)),
        b=b.at[:, 0].set(b0),
        C=C.at[:, :, 0].set(C0),
        J=J.at[:, :, 0].set(J0),
        eta=eta.at[:, 0].set(eta0),
    )


def filtering_operator_tl(
    e1: FilteringElementTL, e2: FilteringElementTL
) -> FilteringElementTL:
    """Associative combine, identical algebra to
    kalman.parallel.filtering_operator, fully elementwise over T."""
    A1, b1, C1, J1, eta1 = e1
    A2, b2, C2, J2, eta2 = e2
    d = A1.shape[0]
    # Identity broadcast over any trailing block/batch dims (the two-level
    # scan runs the operator on (d, d, B, Lb)-blocked leaves).
    I = jnp.broadcast_to(
        jnp.eye(d, dtype=A1.dtype).reshape((d, d) + (1,) * (A1.ndim - 2)),
        A1.shape,
    )

    V = _inv(I + _mm(C1, J2))
    U = _mm(A2, V)  # A2 (I + C1 J2)⁻¹
    A = _mm(U, A1)
    b = _mv(U, b1 + _mv(C1, eta2)) + b2
    C = _mm(_mm(U, C1), _mt(A2)) + C2

    # Symmetric C1/J2 ⇒ I + J2 C1 = (I + C1 J2)ᵀ: reuse Vᵀ instead of a
    # second inverse (one inverse + one matmul saved per combine).
    W = _mm(_mt(A1), _mt(V))  # A1ᵀ (I + J2 C1)⁻¹
    eta = _mv(W, eta2 - _mv(J2, b1)) + eta1
    J = _mm(_mm(W, J2), A1) + J1

    return FilteringElementTL(A=A, b=b, C=_sym(C), J=_sym(J), eta=eta)


def smoothing_operator_tl(
    e1: SmoothingElementTL, e2: SmoothingElementTL
) -> SmoothingElementTL:
    E1, g1, L1 = e1
    E2, g2, L2 = e2
    E = _mm(E2, E1)
    g = _mv(E2, g1) + g2
    L = _mm(_mm(E2, L1), _mt(E2)) + L2
    return SmoothingElementTL(E=E, g=g, L=L)


# --------------------------------------------------------------------------
# Kogge-Stone scan over the time (last) axis
# --------------------------------------------------------------------------


_BLOCKED_SCAN_MIN_T = 8192


def kogge_stone_scan_tl(operator, elems, identity, reverse: bool = False):
    """Inclusive associative scan over the LAST axis.

    Small T: Kogge-Stone — ceil(log2 T) rounds of roll + masked-identity +
    combine, every round one fused elementwise pass over the planes.

    Large T (≥ 8192): two-level — reshape the scan axis to (B, √T̃), run
    Kogge-Stone within blocks (log2 √T̃ rounds of FULL-size passes instead
    of log2 T — ~half the HBM traffic at T = 10⁶), recursively scan the B
    block totals (tiny), and fold each block's exclusive prefix back in.
    Same math, plain differentiable JAX.

    ``identity`` leaves are shaped like one element with no T axis
    (e.g. (d, d)); combining with the identity is exact.

    For ``reverse=True`` accumulates from the right with the later partial
    applied on the LEFT (matching ``lax.associative_scan(reverse=True)``).
    """
    leaves = jax.tree.leaves(elems)
    T = leaves[0].shape[-1]
    if T >= _BLOCKED_SCAN_MIN_T:
        return _blocked_scan_tl(operator, elems, identity, reverse)
    return _kogge_stone_flat_tl(operator, elems, identity, reverse)


def _blocked_scan_tl(operator, elems, identity, reverse: bool):
    leaves = jax.tree.leaves(elems)
    T = leaves[0].shape[-1]
    dtype = leaves[0].dtype
    Lb = 1 << max(1, math.ceil(math.log2(math.sqrt(T))))
    B = -(-T // Lb)
    Tp = B * Lb

    def pad(x, ident):
        if Tp == T:
            return x
        fill = jnp.broadcast_to(
            ident[..., None].astype(dtype), x.shape[:-1] + (Tp - T,)
        )
        # Forward scans pad at the END, reverse at the FRONT, so real
        # elements keep their prefixes/suffixes intact.
        return (
            jnp.concatenate([x, fill], axis=-1)
            if not reverse
            else jnp.concatenate([fill, x], axis=-1)
        )

    blocked = jax.tree.map(
        lambda x, i: pad(x, i).reshape(x.shape[:-1] + (B, Lb)),
        elems,
        identity,
    )
    local = _kogge_stone_flat_tl(operator, blocked, identity, reverse)
    pick = 0 if reverse else -1
    totals = jax.tree.map(lambda x: x[..., pick], local)  # (..., B)
    scanned_tot = kogge_stone_scan_tl(operator, totals, identity, reverse)
    # Exclusive prefix: shift the inclusive totals by one block.
    shift = 1 if reverse else -1

    def excl(x, ident):
        rolled = jnp.roll(x, -shift, axis=-1)
        idx = jnp.arange(B)
        edge = idx == (B - 1 if reverse else 0)
        ident_b = jnp.broadcast_to(ident[..., None].astype(dtype), x.shape)
        return jnp.where(edge, ident_b, rolled)

    prefix = jax.tree.map(excl, scanned_tot, identity)
    prefix_b = jax.tree.map(lambda p: p[..., None], prefix)  # (..., B, 1)
    combined = operator(
        jax.tree.map(lambda p, x: jnp.broadcast_to(p, x.shape), prefix_b, local),
        local,
    )
    out = jax.tree.map(
        lambda x: x.reshape(x.shape[:-2] + (Tp,)), combined
    )
    if Tp != T:
        out = jax.tree.map(
            lambda x: x[..., :T] if not reverse else x[..., Tp - T :], out
        )
    return out


def _kogge_stone_flat_tl(operator, elems, identity, reverse: bool = False):
    leaves = jax.tree.leaves(elems)
    T = leaves[0].shape[-1]
    dtype = leaves[0].dtype
    n_rounds = max(1, math.ceil(math.log2(T))) if T > 1 else 0
    idx = jnp.arange(T)

    shift = 1
    for _ in range(n_rounds):
        if reverse:
            mask = idx < T - shift

            def mk(x, ident):
                rolled = jnp.roll(x, -shift, axis=-1)
                ib = ident.reshape(
                    ident.shape + (1,) * (x.ndim - ident.ndim)
                ).astype(dtype)
                return jnp.where(mask, rolled, jnp.broadcast_to(ib, x.shape))

            partial = jax.tree.map(mk, elems, identity)
            elems = operator(partial, elems)
        else:
            mask = idx >= shift

            def mk(x, ident):
                rolled = jnp.roll(x, shift, axis=-1)
                ib = ident.reshape(
                    ident.shape + (1,) * (x.ndim - ident.ndim)
                ).astype(dtype)
                return jnp.where(mask, rolled, jnp.broadcast_to(ib, x.shape))

            partial = jax.tree.map(mk, elems, identity)
            elems = operator(partial, elems)
        shift *= 2
    return elems


def filtering_identity_tl(d: int, dtype) -> FilteringElementTL:
    return FilteringElementTL(
        A=jnp.eye(d, dtype=dtype),
        b=jnp.zeros((d,), dtype),
        C=jnp.zeros((d, d), dtype),
        J=jnp.zeros((d, d), dtype),
        eta=jnp.zeros((d,), dtype),
    )


def smoothing_identity_tl(d: int, dtype) -> SmoothingElementTL:
    return SmoothingElementTL(
        E=jnp.eye(d, dtype=dtype),
        g=jnp.zeros((d,), dtype),
        L=jnp.zeros((d, d), dtype),
    )


# --------------------------------------------------------------------------
# Engine entry points (same contracts as kalman.parallel.pkf/pks/pkfs)
# --------------------------------------------------------------------------


def pkf_tl(lgssm: LGSSM, observations: Array, return_loglikelihood=False):
    P0, _, _, _, _ = lgssm
    d = P0.shape[0]
    dtype = P0.dtype

    elems = make_filtering_elements_tl(lgssm, observations)
    final = kogge_stone_scan_tl(
        filtering_operator_tl, elems, filtering_identity_tl(d, dtype)
    )
    fms = jnp.moveaxis(final.b, -1, 0)  # (T, d)
    fPs = jnp.moveaxis(final.C, -1, 0)  # (T, d, d)
    if not return_loglikelihood:
        return fms, fPs
    return fms, fPs, _loglik_tl(lgssm, final.b, final.C, observations)


def _loglik_tl(lgssm: LGSSM, b_tl: Array, C_tl: Array, observations: Array):
    """Post-hoc vectorized log-likelihood, elementwise time-last
    (reference: parallel.py:135-151).  b_tl (d, T), C_tl (d, d, T) are the
    scanned filtering moments."""
    P0, Fs, Qs, H, R = lgssm
    return _loglik_from_planes(
        P0,
        jnp.moveaxis(Fs, 0, -1),
        jnp.moveaxis(Qs, 0, -1),
        H,
        R,
        b_tl,
        C_tl,
        observations,
    )


def _loglik_from_planes(
    P0: Array,
    A: Array,
    Q: Array,
    H: Array,
    R: Array,
    b_tl: Array,
    C_tl: Array,
    observations: Array,
):
    d = P0.shape[0]
    dtype = P0.dtype
    T = A.shape[-1]
    h = H[0]
    r = R[0, 0]
    ys = observations.reshape(T)
    mask = jnp.logical_not(jnp.isnan(ys))
    y = jnp.where(mask, jnp.nan_to_num(ys), 0.0)

    m_prev = jnp.concatenate(
        [jnp.zeros((d, 1), dtype), b_tl[:, :-1]], axis=-1
    )
    P_prev = jnp.concatenate([P0[:, :, None], C_tl[:, :, :-1]], axis=-1)
    mp = _mv(A, m_prev)  # (d, T)
    Pp = _mm(_mm(A, P_prev), _mt(A)) + Q
    mean = jnp.sum(h[:, None] * mp, axis=0)  # (T,)
    var = jnp.sum(h[:, None] * _mv(Pp, jnp.broadcast_to(h[:, None], (d, T))), axis=0) + r
    diff = y - mean
    logprobs = -0.5 * (
        diff * diff / var + jnp.log(var) + math.log(2.0 * math.pi)
    )
    return jnp.sum(jnp.where(mask, logprobs, 0.0))


def make_smoothing_elements_tl(
    lgssm: LGSSM, ms: Array, Ps: Array
) -> SmoothingElementTL:
    _, Fs, Qs, *_ = lgssm
    return _smoothing_elements_from_planes(
        jnp.moveaxis(Fs, 0, -1),
        jnp.moveaxis(Qs, 0, -1),
        jnp.moveaxis(ms, 0, -1),
        jnp.moveaxis(Ps, 0, -1),
    )


def _smoothing_elements_from_planes(
    A_all: Array, Q_all: Array, m_all: Array, P_all: Array
) -> SmoothingElementTL:
    """Core smoothing-element construction on time-last planes:
    A_all/Q_all (d, d, T), m_all (d, T), P_all (d, d, T)."""
    d = A_all.shape[0]
    dtype = A_all.dtype

    A = A_all[:, :, 1:]  # (d, d, T-1)
    Q = Q_all[:, :, 1:]
    m = m_all[:, :-1]  # (d, T-1)
    P = P_all[:, :, :-1]

    Pp = _mm(_mm(A, P), _mt(A)) + Q
    FP = _mm(A, P)
    E = _mt(_mm(_inv(_sym(Pp)), FP))
    g = m - _mv(_mm(E, A), m)
    L = _sym(P - _mm(_mm(E, Pp), _mt(E)))

    return SmoothingElementTL(
        E=jnp.concatenate([E, jnp.zeros((d, d, 1), dtype)], axis=-1),
        g=jnp.concatenate([g, m_all[:, -1:]], axis=-1),
        L=jnp.concatenate([L, P_all[:, :, -1:]], axis=-1),
    )


def pks_tl(lgssm: LGSSM, ms: Array, Ps: Array):
    d = lgssm.P0.shape[0]
    dtype = lgssm.P0.dtype
    elems = make_smoothing_elements_tl(lgssm, ms, Ps)
    final = kogge_stone_scan_tl(
        smoothing_operator_tl,
        elems,
        smoothing_identity_tl(d, dtype),
        reverse=True,
    )
    return jnp.moveaxis(final.g, -1, 0), jnp.moveaxis(final.L, -1, 0)


def pkfs_tl(lgssm: LGSSM, observations: Array):
    fms, fPs = pkf_tl(lgssm, observations)
    return pks_tl(lgssm, fms, fPs)


# --------------------------------------------------------------------------
# LGSSMTL-native entry points: zero relayouts end-to-end.
#
# The (T, d, d) ↔ (d, d, T) transposes that the LGSSM wrappers above pay
# would cost more than the scan itself at T = 10⁶; kernels emit LGSSMTL
# directly (SDEKernel.get_ssm_tl) and these functions keep every
# intermediate time-last, converting only the final user-facing moments.
# --------------------------------------------------------------------------


def pkf_from_tl(
    lgssm_tl,
    observations: Array,
    return_loglikelihood: bool = False,
):
    """Parallel Kalman filter on a time-last LGSSMTL; returns time-last
    moments (b (d, T), C (d, d, T)[, ell])."""
    P0, Fs_tl, Qs_tl, H, R = lgssm_tl
    d = P0.shape[0]
    dtype = P0.dtype
    e = _filtering_elements_from_planes(P0, Fs_tl, Qs_tl, H, R, observations)
    final = kogge_stone_scan_tl(
        filtering_operator_tl, e, filtering_identity_tl(d, dtype)
    )
    b_tl, C_tl = final.b, final.C
    if not return_loglikelihood:
        return b_tl, C_tl
    ell = _loglik_from_planes(
        P0, Fs_tl, Qs_tl, H, R, b_tl, C_tl, observations
    )
    return b_tl, C_tl, ell


def pks_from_tl(lgssm_tl, b_tl: Array, C_tl: Array):
    """Parallel RTS smoother on time-last moments; returns (g_tl, L_tl)."""
    P0, Fs_tl, Qs_tl, _, _ = lgssm_tl
    d = P0.shape[0]
    e = _smoothing_elements_from_planes(Fs_tl, Qs_tl, b_tl, C_tl)
    final = kogge_stone_scan_tl(
        smoothing_operator_tl,
        e,
        smoothing_identity_tl(d, P0.dtype),
        reverse=True,
    )
    return final.g, final.L


def pkfs_from_tl(lgssm_tl, observations: Array, time_first_out: bool = True):
    """Filter + smoother on an LGSSMTL; the filtered moments stay time-last
    between the two scans (no mid-pipeline relayout).

    Returns (sms (T, d), sPs (T, d, d)) when ``time_first_out`` (the
    reference layout), else the raw time-last (g_tl (d, T), L_tl (d, d, T))."""
    b_tl, C_tl = pkf_from_tl(lgssm_tl, observations)
    g_tl, L_tl = pks_from_tl(lgssm_tl, b_tl, C_tl)
    if not time_first_out:
        return g_tl, L_tl
    return jnp.moveaxis(g_tl, -1, 0), jnp.moveaxis(L_tl, -1, 0)


# --------------------------------------------------------------------------
# Fisher-identity log-marginal-likelihood with a custom VJP.
#
# Reverse-mode autodiff through the Kogge-Stone scan replays ~log2(T)
# full-size passes forward AND backward.  But the gradient of an LGSSM's
# log-likelihood has a CLOSED FORM in the smoothed posterior (Fisher's
# identity, ∇θ ℓ = E_{x|y}[∇θ log p(x, y)]): backward = ONE smoother pass +
# elementwise formulas.
#
# Generative model differentiated: x₋₁ ~ N(0, P0); x_k = F_k x_{k−1} + w_k,
# w_k ~ N(0, Q_k); y_k = H x_k + v_k, v_k ~ N(0, R); NaN = missing.
#
# CONTRACT: the forward value equals the post-hoc likelihood the engines
# compute (reference pssgp/kalman/parallel.py:135-151) for any input, but
# the VJP is exact only for *stationarity-consistent* SSMs — those with
# Q_k = P0 − F_k P0 F_kᵀ, which ``ops.disc.discretize(_tl)`` guarantees by
# construction for every kernel in the framework.  Off that manifold the
# first-step term differs (the engines update step 0 against P0 directly
# rather than F_0 P0 F_0ᵀ + Q_0).  Hyperparameter gradients — the only
# gradients the framework takes — are exact, because discretization maps
# parameter perturbations onto the manifold's tangent.  Pinned against
# end-to-end autodiff of the XLA engine in tests.
# --------------------------------------------------------------------------


def _smoother_gains_tl(Fs_tl, Qs_tl, b_tl, C_tl):
    """RTS gains E_k = (Pp_{k+1}⁻¹ F_{k+1} P_k)ᵀ for k = 0..T−2, (d, d, T−1):
    Cov(x_{k+1}, x_k | y) = P̂_{k+1} E_kᵀ."""
    A = Fs_tl[:, :, 1:]
    Q = Qs_tl[:, :, 1:]
    P = C_tl[:, :, :-1]
    Pp = _sym(_mm(_mm(A, P), _mt(A)) + Q)
    return _mt(_mm(_inv(Pp), _mm(A, P)))


@jax.custom_vjp
def lml_tl(lgssm_tl, observations):
    """Log marginal likelihood of an LGSSMTL with Fisher-identity gradients
    (see section comment)."""
    _, _, ell = pkf_from_tl(lgssm_tl, observations, return_loglikelihood=True)
    return ell


def _lml_tl_fwd(lgssm_tl, observations):
    b_tl, C_tl, ell = pkf_from_tl(
        lgssm_tl, observations, return_loglikelihood=True
    )
    return ell, (lgssm_tl, observations, b_tl, C_tl)


def _lml_tl_bwd(residuals, gbar):
    lgssm_tl, observations, b_tl, C_tl = residuals
    mhat, Phat = pks_from_tl(lgssm_tl, b_tl, C_tl)
    return fisher_grads_from_smoothed(
        lgssm_tl, observations, b_tl, C_tl, mhat, Phat, gbar
    )


def fisher_grads_from_smoothed(
    lgssm_tl, observations, b_tl, C_tl, mhat, Phat, gbar
):
    """Fisher-identity LML cotangents from filtered (b, C) and smoothed
    (m̂, P̂) time-last moments — the elementwise tail of the custom VJP,
    shared by the single-chip ``lml_tl`` and the time-axis-sharded
    ``parallel.sharded.sharded_lml_tl`` (the formulas are elementwise over
    T apart from one-step shifts, so GSPMD partitions them from the operand
    shardings).  Returns (LGSSMTL cotangent, ∂ℓ/∂y)."""
    P0, Fs, Qs, H, R = lgssm_tl
    d = P0.shape[0]
    dtype = P0.dtype
    T = Fs.shape[-1]
    h = H[0]
    r = R[0, 0]

    ys = observations.reshape(T)
    mask = jnp.logical_not(jnp.isnan(ys))
    y = jnp.where(mask, jnp.nan_to_num(ys), 0.0)
    maskf = mask.astype(dtype)

    # RTS gains E_{k−1} (pair (k−1, k), aligned with transition k;
    # pre-initial gain E₋₁ from P0).
    E = _smoother_gains_tl(Fs, Qs, b_tl, C_tl)
    F0 = Fs[:, :, 0]
    Q0 = Qs[:, :, 0]
    Pp0 = mm(mm(F0, P0), F0.T) + Q0
    # Time-last inverse on a T = 1 plane: no LU, any dtype/backend.
    Pp0inv = _inv(_sym(Pp0[:, :, None]))[:, :, 0]
    Em1 = mm(Pp0inv, mm(F0, P0)).T  # P0 F0ᵀ Pp0⁻¹
    E_prev = jnp.concatenate([Em1[:, :, None], E], axis=-1)
    mham1 = mm(Em1, mhat[:, 0])  # m̂₋₁ (mp₀ = 0)
    mh_prev = jnp.concatenate([mham1[:, None], mhat[:, :-1]], axis=-1)

    # Predicted moments mp_k = F_k m_{k−1}, Pp_k = F_k P_{k−1} F_kᵀ + Q_k.
    m_prev = jnp.concatenate([jnp.zeros((d, 1), dtype), b_tl[:, :-1]], axis=-1)
    P_prev = jnp.concatenate([P0[:, :, None], C_tl[:, :, :-1]], axis=-1)
    mp = _mv(Fs, m_prev)
    Pp = _sym(_mm(_mm(Fs, P_prev), _mt(Fs)) + Qs)

    # Cancellation-free Fisher gradients.  The naive forms
    # ∇Q = ½(Q⁻¹MQ⁻¹ − Q⁻¹), ∇F = Q⁻¹(U − FS') are catastrophically
    # ill-conditioned at small dt (Q = O(dt·…) nearly singular while the
    # gradient is O(1)).  Substituting the RTS identities
    # I − F_k E_{k−1} = Q_k Pp_k⁻¹,  ŵ_k = Q_k Pp_k⁻¹ δ_k,
    # Cov(w_k, x_{k−1}|y) = Q_k Pp_k⁻¹ D_k E_{k−1}ᵀ,
    # Cov(w_k|y) − Q_k = Q_k Pp_k⁻¹ D_k Pp_k⁻¹ Q_k,
    # with δ_k = m̂_k − mp_k and D_k = P̂_k − Pp_k, every Q⁻¹ cancels:
    #   ∇Q_k = ½ (Pp⁻¹ D Pp⁻¹ + r rᵀ),   r_k = Pp_k⁻¹ δ_k
    #   ∇F_k = r_k m̂_{k−1}ᵀ + Pp⁻¹ D E_{k−1}ᵀ
    #   ∇P0  = F₀ᵀ (∇Q)₀ F₀
    # — only the well-conditioned predicted covariance is ever inverted.
    Ppinv = _inv(Pp)
    delta = mhat - mp  # (d, T)
    Dk = Phat - Pp  # (d, d, T)
    rk = _mv(Ppinv, delta)  # (d, T)
    PiD = _mm(Ppinv, Dk)
    dQ = 0.5 * (_mm(PiD, Ppinv) + rk[:, None, :] * rk[None, :, :])
    dF = rk[:, None, :] * mh_prev[None, :, :] + _mm(PiD, _mt(E_prev))
    dP0 = mm(mm(F0.T, dQ[:, :, 0]), F0)

    # Observation terms (observed steps only); R is (1, 1).
    Hm = jnp.sum(h[:, None] * mhat, axis=0)  # (T,)
    resid = y - Hm
    HPhat = jnp.sum(h[:, None, None] * Phat, axis=0)  # (d, T): (H P̂)_j
    # ∇H = R⁻¹ Σ [(y − Hm̂) m̂ᵀ − H P̂]
    dH = (
        jnp.sum(maskf[None] * (resid[None] * mhat - HPhat), axis=-1) / r
    )[None, :]
    # ∇R = ½ Σ [R⁻¹ N R⁻¹ − R⁻¹],  N = resid² + H P̂ Hᵀ
    HPH = jnp.sum(h[:, None] * HPhat, axis=0)  # (T,)
    Nk = resid * resid + HPH
    dR = jnp.sum(0.5 * maskf * (Nk / (r * r) - 1.0 / r)).reshape(1, 1)
    # ∇y_k = −R⁻¹ (y_k − H m̂_k) at observed steps
    dy = jnp.where(mask, -resid / r, 0.0).reshape(observations.shape)

    from parallel_gps_tpu.types import LGSSMTL

    g = gbar.astype(dtype)
    return (
        LGSSMTL(g * dP0, g * dF, g * dQ, g * dH, g * dR),
        g * dy,
    )


lml_tl.defvjp(_lml_tl_fwd, _lml_tl_bwd)
