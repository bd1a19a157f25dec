"""Square-root (Cholesky-factor) parallel Kalman engine — the f32
stability axis (filter + smoother + Fisher-identity training gradients).

The standard filtering-element combine (kalman/parallel.py::filtering_operator,
reference pssgp/kalman/parallel.py:100-118) subtracts covariance products
(C = Q − KᵀHQ, two (I + C1J2)-solves), which is where d ≳ 12 f32 runs lose
positive-definiteness and go NaN (BASELINE.md d>8 battery).  Here the
elements carry triangular FACTORS instead:

    (A, b, U, Z, eta)   with   C = U Uᵀ,   J = Z Zᵀ,

and the combine reconstructs everything from two Cholesky factorizations of
GRAM matrices that are ≥ I by construction —

    Ψ = I + U1ᵀ J2 U1 = I + Yᵀ Y,      Y = Z2ᵀ U1,
    Φ = I + Z2ᵀ C1 Z2 = I + Y Yᵀ,

(eigenvalues ≥ 1 ⇒ chol never fails, condition ≤ 1 + ‖Y‖²) — plus
QR-based triangularizations (`tria`) whose results are PSD factors by
construction.  Derivation: apply Woodbury to Lemma 7/8 of Särkkä &
García-Fernández (arXiv 1905.13002):

    (I + C1J2)⁻¹C1 = U1 Ψ⁻¹ U1ᵀ                  → C  = tria([A2U1S⁻ᵀ, U2])
    (I + J2C1)⁻¹J2 = Z2 Φ⁻¹ Z2ᵀ                  → J  = tria([A1ᵀZ2T⁻ᵀ, Z1])
    (I + C1J2)⁻¹   = I − U1 Ψ⁻¹ Yᵀ Z2ᵀ
    (I + J2C1)⁻¹   = I − Z2 Φ⁻¹ Y U1ᵀ

with S = chol(Ψ), T = chol(Φ).  This is the square-root associative-filter
family of Yaghoobi–Corenflos–Hassan–Särkkä ("Parallel square-root solutions
for Bayesian smoothers", arXiv 2207.00426) re-derived in the repo's element
convention.  Element construction uses Joseph-form factor updates, and
process-noise factors come from an eigh-based PSD square root (zero-clamped:
exact for the singular Q of deterministic oscillator components, no chol-NaN
at tiny dt).

Scope: generic time-first layout, full-rank d×d factors, filter +
smoother + post-hoc LML (``sqrt_pkf``/``sqrt_pks``/``sqrt_pkfs`` and the
kernel entries); the fused-kernel layouts keep the standard engines.
~2-3× the flops of the standard combine (QRs) — this trades speed for
the reference's f64 stability axis staying on-chip.  Reachable from the
model API via ``StateSpaceGP.create(..., stable=True)``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu.ops.linalg import mvn_logpdf, solve_small
from parallel_gps_tpu.ops.scan import blocked_associative_scan
from parallel_gps_tpu.types import LGSSM


class SqrtFilteringElement(NamedTuple):
    A: Array  # (..., d, d)
    b: Array  # (..., d)
    U: Array  # (..., d, d)  C = U Uᵀ
    Z: Array  # (..., d, d)  J = Z Zᵀ
    eta: Array  # (..., d)


class SqrtSmoothingElement(NamedTuple):
    E: Array  # (..., d, d)
    g: Array  # (..., d)
    N: Array  # (..., d, d)  L = N Nᵀ


def tria(M: Array) -> Array:
    """Lower-triangular L with L Lᵀ = M Mᵀ for M (..., d, k), k ≥ d, via QR
    of Mᵀ (the square-root filtering primitive)."""
    R = jnp.linalg.qr(jnp.swapaxes(M, -1, -2), mode="r")
    return jnp.swapaxes(R, -1, -2)


def _bcat(a: Array, b: Array) -> Array:
    """Concatenate along the last axis with batch-dims broadcasting (the
    blocked scan combines (B, 1, …) prefixes against (B, n, …) elements —
    plain concatenate requires equal batch shapes)."""
    shape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = jnp.broadcast_to(a, shape + (a.shape[-1],))
    b = jnp.broadcast_to(b, shape + (b.shape[-1],))
    return jnp.concatenate([a, b], axis=-1)


def psd_sqrt(M: Array) -> Array:
    """Symmetric PSD square root via eigh with zero-clamped eigenvalues —
    never NaNs (unlike chol) for singular or roundoff-indefinite PSD inputs
    (tiny-dt Q, deterministic Periodic components).

    Factorizing an ASSEMBLED graded matrix is accurate only to ‖M‖·eps
    absolute (Jacobi equilibration was tried and measured WORSE: the √ of
    the equilibrated eigenvalues amplifies the absolute eigh error into
    ~√eps relative factor error — f64 RBF-6 LML parity degraded 1.9e-12 →
    1.9e-4).  Where per-entry relative accuracy matters (f32 d ≥ 12),
    build factors structurally instead: gramian_disc_factors."""
    w, V = jnp.linalg.eigh(0.5 * (M + jnp.swapaxes(M, -1, -2)))
    return V * jnp.sqrt(jnp.maximum(w, 0.0))[..., None, :] @ jnp.swapaxes(
        V, -1, -2
    )


def _mv(M: Array, v: Array) -> Array:
    return (M @ v[..., None])[..., 0]


def _chol_solve(L: Array, B: Array) -> Array:
    """(L Lᵀ)⁻¹ B for lower-triangular L, batched."""
    from jax.scipy.linalg import solve_triangular

    y = solve_triangular(L, B, lower=True)
    return solve_triangular(jnp.swapaxes(L, -1, -2), y, lower=False)


def _tri_solve_t(L: Array, B: Array) -> Array:
    """B L⁻ᵀ for lower-triangular L, batched: (L⁻¹ Bᵀ)ᵀ."""
    from jax.scipy.linalg import solve_triangular

    return jnp.swapaxes(
        solve_triangular(L, jnp.swapaxes(B, -1, -2), lower=True), -1, -2
    )


def gramian_disc_factors(kernel, dts: Array, nodes: int = 8) -> Array:
    """Square-root DISCRETIZATION: per-step (d, nodes) factors G_k with
    G_k G_kᵀ = Q_k = ∫₀^{dt_k} e^{Fs} L q Lᵀ e^{Fᵀs} ds, by Gauss–Legendre
    quadrature of the Gramian's columns:

        G_k[:, i] = √(w_i · dt_k/2 · q) · e^{F s_i} L,   s_i ∈ (0, dt_k).

    Unlike an eigh/chol factorization of the assembled Q (whose entries are
    only accurate to ‖Q‖·eps ABSOLUTE — fatal for companion-form Q whose
    entries span dt¹..dt^{2d−1}), each quadrature column is computed to
    f32 RELATIVE accuracy from the kernel's closed-form transitions
    (`transitions_m1`; Padé fallback), so U Uᵀ reproduces Q entrywise.
    This is what makes the square-root engine's stability win hold in f32
    (see BASELINE.md d=12 envelope).  Requires L of shape (d, 1) and
    scalar q (every companion-form kernel; Periodic has Q = 0 — pass
    factors of zeros)."""
    import numpy as np

    sde = kernel.get_sde()
    d = sde.F.shape[0]
    dtype = sde.F.dtype
    T = dts.shape[0]
    if sde.L.shape[1] != 1:
        raise ValueError("gramian_disc_factors needs a rank-1 L (d, 1)")
    x, w = np.polynomial.legendre.leggauss(nodes)
    Lq = (sde.L[:, 0] * jnp.sqrt(sde.Q.reshape(()))).astype(dtype)  # (d,)
    cols = []
    for i in range(nodes):
        alpha = 0.5 * (x[i] + 1.0)
        s_i = (dts * alpha).astype(dtype)
        Am1 = kernel.transitions_m1(s_i)
        if Am1 is None:
            from parallel_gps_tpu.ops.expm import expm1_dt_batched

            Am1 = expm1_dt_batched(sde.F, s_i.astype(dtype))
        col = _mv(Am1, jnp.broadcast_to(Lq, (T, d))) + Lq[None, :]
        scale = jnp.sqrt(0.5 * w[i] * dts).astype(dtype)
        cols.append(col * scale[:, None])
    return jnp.stack(cols, axis=-1)  # (T, d, nodes)


def sqrt_filtering_identity(d: int, dtype) -> SqrtFilteringElement:
    return SqrtFilteringElement(
        A=jnp.eye(d, dtype=dtype),
        b=jnp.zeros((d,), dtype),
        U=jnp.zeros((d, d), dtype),
        Z=jnp.zeros((d, d), dtype),
        eta=jnp.zeros((d,), dtype),
    )


def sqrt_filtering_operator(
    elem1: SqrtFilteringElement, elem2: SqrtFilteringElement
) -> SqrtFilteringElement:
    """Associative combine in square-root form (module docstring math)."""
    A1, b1, U1, Z1, eta1 = elem1
    A2, b2, U2, Z2, eta2 = elem2
    d = A1.shape[-1]
    I = jnp.eye(d, dtype=A1.dtype)

    Y = jnp.swapaxes(Z2, -1, -2) @ U1  # (.., d, d)
    Yt = jnp.swapaxes(Y, -1, -2)
    S = jnp.linalg.cholesky(I + Yt @ Y)  # chol(Ψ), eigs ≥ 1
    T = jnp.linalg.cholesky(I + Y @ Yt)  # chol(Φ)

    w = _mv(jnp.swapaxes(U1, -1, -2), eta2)
    v = _mv(jnp.swapaxes(Z2, -1, -2), b1)

    # A = A2 (A1 − U1 Ψ⁻¹ Yᵀ Z2ᵀ A1),  b = A2 (b1 + U1 Ψ⁻¹ (w − Yᵀv)) + b2
    Xa = jnp.swapaxes(Z2, -1, -2) @ A1
    A = A2 @ (A1 - U1 @ _chol_solve(S, Yt @ Xa))
    b = _mv(A2, b1 + _mv(U1, _chol_solve(S, (w - _mv(Yt, v))[..., None])[..., 0])) + b2

    # U = tria([A2 U1 S⁻ᵀ, U2])
    U = tria(_bcat(_tri_solve_t(S, A2 @ U1), U2))

    # Z = tria([A1ᵀ Z2 T⁻ᵀ, Z1]);  A1ᵀZ2 T⁻ᵀ = (T⁻¹ Z2ᵀ A1)ᵀ
    from jax.scipy.linalg import solve_triangular

    Z = tria(
        _bcat(
            jnp.swapaxes(solve_triangular(T, Xa, lower=True), -1, -2), Z1
        )
    )

    # η = A1ᵀ (arg − Z2 Φ⁻¹ Y (w − Yᵀ v)) + η1,  arg = η2 − Z2 v
    arg = eta2 - _mv(Z2, v)
    corr = _mv(Z2, _chol_solve(T, _mv(Y, w - _mv(Yt, v))[..., None])[..., 0])
    eta = _mv(jnp.swapaxes(A1, -1, -2), arg - corr) + eta1

    return SqrtFilteringElement(A=A, b=b, U=U, Z=Z, eta=eta)


def make_sqrt_filtering_elements(
    lgssm: LGSSM,
    observations: Array,
    sqQ: Array | None = None,
    sqP0: Array | None = None,
) -> SqrtFilteringElement:
    """Square-root per-step elements (cf. parallel.make_filtering_elements),
    with Joseph-form covariance factors:

        C = (I − KᵀH) Q (I − KᵀH)ᵀ + Kᵀ R K   →  U = tria([(I−KᵀH)√Q, Kᵀ√R])

    ``sqQ``: optional per-step (T, d, k) process-noise factors (e.g. the
    entrywise-accurate quadrature factors of gramian_disc_factors) — the
    default eigh factorization of the assembled Q loses the graded small
    entries at f32.  ``sqP0`` likewise for the stationary covariance."""
    P0, Fs, Qs, H, R = lgssm
    dtype = P0.dtype
    d = P0.shape[0]
    m = H.shape[0]
    T = Fs.shape[0]
    m0 = jnp.zeros((d,), dtype)
    I = jnp.eye(d, dtype=dtype)

    ys = observations.reshape(T, m)
    mask = jnp.logical_not(jnp.any(jnp.isnan(ys), axis=-1))
    y = jnp.where(mask[:, None], jnp.nan_to_num(ys), 0.0)

    sqQ = psd_sqrt(Qs) if sqQ is None else sqQ  # (T, d, k)
    # square (d, d) variant for the missing-observation branch
    sqQ_sq = sqQ if sqQ.shape[-1] == d else tria(sqQ)
    sqR = psd_sqrt(R)  # (m, m)

    HQ = H[None] @ Qs
    S = HQ @ H.T + R
    Kt = jnp.swapaxes(solve_small(S, HQ), -1, -2)  # (T, d, m): Kᵀ as (d, m)
    HF = H[None] @ Fs
    IKH = I[None] - Kt @ H[None]

    A_ok = IKH @ Fs
    b_ok = _mv(Kt, y)
    U_ok = tria(jnp.concatenate([IKH @ sqQ, Kt @ sqR], axis=-1))
    # J = (HF)ᵀ S⁻¹ (HF) → Z columns (HF)ᵀ chol(S)⁻ᵀ, zero-padded to d
    cS = jnp.linalg.cholesky(S)
    Zcols = _tri_solve_t(cS, jnp.swapaxes(HF, -1, -2))  # (T, d, m)
    Z_ok = jnp.concatenate([Zcols, jnp.zeros((T, d, d - m), dtype)], axis=-1)
    eta_ok = _mv(jnp.swapaxes(HF, -1, -2), solve_small(S, y[..., None])[..., 0])

    m3 = mask[:, None, None]
    m2 = mask[:, None]
    A = jnp.where(m3, A_ok, Fs)
    b = jnp.where(m2, b_ok, 0.0)
    U = jnp.where(m3, U_ok, sqQ_sq)
    Z = jnp.where(m3, Z_ok, 0.0)
    eta = jnp.where(m2, eta_ok, 0.0)

    # First element: update against (m0, P0) (reference parallel.py:13-43).
    sqP0 = psd_sqrt(P0) if sqP0 is None else sqP0
    S1 = H @ P0 @ H.T + R
    K1t = jnp.swapaxes(solve_small(S1, H @ P0), -1, -2)  # (d, m)
    b0_ok = m0 + _mv(K1t, y[0] - _mv(H, m0))
    U0_ok = tria(
        jnp.concatenate([(I - K1t @ H) @ sqP0, K1t @ sqR], axis=-1)
    )
    S0 = H @ Qs[0] @ H.T + R
    HF0 = H @ Fs[0]
    cS0 = jnp.linalg.cholesky(S0)
    Z0cols = _tri_solve_t(cS0, HF0.T)
    Z0_ok = jnp.concatenate([Z0cols, jnp.zeros((d, d - m), dtype)], axis=-1)
    eta0_ok = (HF0.T @ solve_small(S0, y[0][:, None]))[:, 0]

    ok0 = mask[0]
    A0 = jnp.zeros((d, d), dtype)
    b0 = jnp.where(ok0, b0_ok, m0)
    sqP0_sq = sqP0 if sqP0.shape[-1] == d else tria(sqP0)
    U0 = jnp.where(ok0, U0_ok, sqP0_sq)
    Z0 = jnp.where(ok0, Z0_ok, 0.0)
    eta0 = jnp.where(ok0, eta0_ok, 0.0)

    return SqrtFilteringElement(
        A=A.at[0].set(A0),
        b=b.at[0].set(b0),
        U=U.at[0].set(U0),
        Z=Z.at[0].set(Z0),
        eta=eta.at[0].set(eta0),
    )


def sqrt_pkf(
    lgssm: LGSSM,
    observations: Array,
    return_loglikelihood: bool = False,
    sqQ: Array | None = None,
    sqP0: Array | None = None,
):
    """Square-root parallel Kalman filter: returns (fms (T, d), fUs (T, d, d)
    lower factors with P = U Uᵀ[, ell]).  Covariances stay PSD by
    construction at any conditioning — the f32 d ≳ 12 stability engine
    (standard engines: kalman/parallel.py).

    Traced under full-f32 matmul precision: at the default precision a
    float32 matmul may run with reduced-mantissa inputs (TF32 on GPUs),
    which costs this matmul/QR-heavy engine digits at d=12 and is fatal to
    triangular factors — the elementwise TL engine never sees this because
    it has no matmuls.

    ``sqQ``/``sqP0``: optional entrywise-accurate factors (see
    gramian_disc_factors / make_sqrt_filtering_elements); default = eigh
    factorization of the assembled planes."""
    with jax.default_matmul_precision("float32"):
        return _sqrt_pkf_impl(
            lgssm, observations, return_loglikelihood, sqQ, sqP0
        )


def _sqrt_pkf_impl(
    lgssm: LGSSM,
    observations: Array,
    return_loglikelihood: bool = False,
    sqQ: Array | None = None,
    sqP0: Array | None = None,
):
    P0, Fs, Qs, H, R = lgssm
    dtype = P0.dtype
    d = P0.shape[0]
    m0 = jnp.zeros((d,), dtype)

    elems = make_sqrt_filtering_elements(lgssm, observations, sqQ, sqP0)
    final = blocked_associative_scan(
        sqrt_filtering_operator, elems, sqrt_filtering_identity(d, dtype)
    )
    fms, fUs = final.b, final.U
    if not return_loglikelihood:
        return fms, fUs

    # Post-hoc vectorized log-likelihood (cf. parallel.pkf): innovation
    # variance from the factor — H Pp Hᵀ = ‖HF U_prev‖² + ‖H √Q‖² ≥ 0.
    ys = observations.reshape(-1, H.shape[0])
    mask = jnp.logical_not(jnp.any(jnp.isnan(ys), axis=-1))
    y = jnp.where(mask[:, None], jnp.nan_to_num(ys), 0.0)

    prev_ms = jnp.concatenate([m0[None], fms[:-1]], axis=0)
    sqP0 = psd_sqrt(P0) if sqP0 is None else tria(sqP0)
    prev_Us = jnp.concatenate([sqP0[None], fUs[:-1]], axis=0)
    sqQ = psd_sqrt(Qs) if sqQ is None else sqQ
    mps = _mv(Fs, prev_ms)
    HFU = H[None] @ Fs @ prev_Us  # (T, m, d)
    HsQ = H[None] @ sqQ
    obs_means = _mv(H[None], mps)
    obs_covs = (
        HFU @ jnp.swapaxes(HFU, -1, -2)
        + HsQ @ jnp.swapaxes(HsQ, -1, -2)
        + R
    )
    logprobs = mvn_logpdf(y, obs_means, obs_covs)
    ell = jnp.sum(jnp.where(mask, logprobs, 0.0))
    return fms, fUs, ell


def sqrt_pkf_kernel(
    kernel,
    ts: Array,
    R,
    observations: Array,
    return_loglikelihood: bool = False,
    nodes: int | None = None,
    t0=0.0,
):
    """Square-root filter straight from a kernel: the SSM is discretized as
    usual (cancellation-free planes for the solves/gains) while the
    covariance FACTORS come from the quadrature Gramian
    (gramian_disc_factors) — entrywise-accurate square-root discretization,
    no eigh of graded matrices anywhere on the critical path."""
    ts = jnp.asarray(ts).reshape(-1, 1)
    R = jnp.asarray(R).reshape(1, 1)
    lgssm = kernel.get_ssm(ts, R, t0)
    sqQ, sqP0 = kernel_sq_factors(kernel, ts, lgssm, nodes, t0)
    return sqrt_pkf(
        lgssm, observations, return_loglikelihood, sqQ=sqQ, sqP0=sqP0
    )


# ---------------------------------------------------------------------------
# Square-root smoother (parallel RTS on Cholesky factors)
# ---------------------------------------------------------------------------


def sqrt_smoothing_identity(d: int, dtype) -> SqrtSmoothingElement:
    return SqrtSmoothingElement(
        E=jnp.eye(d, dtype=dtype),
        g=jnp.zeros((d,), dtype),
        N=jnp.zeros((d, d), dtype),
    )


def sqrt_smoothing_operator(
    elem1: SqrtSmoothingElement, elem2: SqrtSmoothingElement
) -> SqrtSmoothingElement:
    """Square-root form of the smoothing combine
    (kalman/parallel.py::smoothing_operator, reference parallel.py:176-184):
    L = E2 L1 E2ᵀ + L2 on factors is one QR triangularization."""
    E1, g1, N1 = elem1
    E2, g2, N2 = elem2
    return SqrtSmoothingElement(
        E=E2 @ E1,
        g=_mv(E2, g1) + g2,
        N=tria(_bcat(E2 @ N1, N2)),
    )


def make_sqrt_smoothing_elements(
    lgssm: LGSSM, fms: Array, fUs: Array, sqQ: Array | None = None
) -> SqrtSmoothingElement:
    """Per-step smoothing elements from FACTORED filtered results (fUs with
    P = U Uᵀ), built by one block triangularization per step instead of the
    standard path's Pp-solve (cf. make_smoothing_elements):

        Ψ = tria([[F U, G], [U, 0]]) = [[Ψ11, 0], [Ψ21, Ψ22]]

    satisfies Ψ Ψᵀ = [[F P Fᵀ + Q, F P], [P Fᵀ, P]], so Ψ11 is a factor of
    the predicted covariance Pp, the gain is E = Ψ21 Ψ11⁻¹ (triangular
    solve, never a PSD solve of an ill-conditioned assembled Pp), and Ψ22
    is a PSD-by-construction factor of L = P − E Pp Eᵀ — the square-root
    smoother family of Yaghoobi et al. (arXiv 2207.00426) in this repo's
    element convention.  ``sqQ``: optional (T, d, k) process-noise factors
    with k ≥ d (quadrature Gramian); default eigh factors of Qs."""
    from jax.scipy.linalg import solve_triangular

    _, Fs, Qs, *_ = lgssm
    T = Fs.shape[0]
    d = Fs.shape[-1]
    dtype = Fs.dtype

    sqQ = psd_sqrt(Qs) if sqQ is None else sqQ
    k = sqQ.shape[-1]
    if k < d:
        sqQ = jnp.concatenate(
            [sqQ, jnp.zeros((T, d, d - k), dtype)], axis=-1
        )
        k = d

    F, G = Fs[1:], sqQ[1:]
    m, U = fms[:-1], fUs[:-1]
    top = jnp.concatenate([F @ U, G], axis=-1)  # (T-1, d, d+k)
    bot = jnp.concatenate(
        [U, jnp.zeros((T - 1, d, k), dtype)], axis=-1
    )
    Psi = tria(jnp.concatenate([top, bot], axis=-2))  # (T-1, 2d, d+k)
    P11 = Psi[..., :d, :d]
    P21 = Psi[..., d:, :d]
    N = Psi[..., d:, d : 2 * d]
    # E Ψ11 = Ψ21  ⇔  Ψ11ᵀ Eᵀ = Ψ21ᵀ (upper-triangular solve)
    E = jnp.swapaxes(
        solve_triangular(
            jnp.swapaxes(P11, -1, -2), jnp.swapaxes(P21, -1, -2),
            lower=False,
        ),
        -1, -2,
    )
    g = m - _mv(E @ F, m)

    return SqrtSmoothingElement(
        E=jnp.concatenate([E, jnp.zeros((1, d, d), dtype)], axis=0),
        g=jnp.concatenate([g, fms[-1][None]], axis=0),
        N=jnp.concatenate([N, fUs[-1][None]], axis=0),
    )


def sqrt_pks(
    lgssm: LGSSM, fms: Array, fUs: Array, sqQ: Array | None = None
):
    """Square-root parallel RTS smoother: (smoothed means (T, d), smoothed
    covariance FACTORS (T, d, d) with P = N Nᵀ — PSD at any conditioning)."""
    with jax.default_matmul_precision("float32"):
        d = fms.shape[-1]
        elems = make_sqrt_smoothing_elements(lgssm, fms, fUs, sqQ)
        final = blocked_associative_scan(
            sqrt_smoothing_operator,
            elems,
            sqrt_smoothing_identity(d, fms.dtype),
            reverse=True,
        )
        return final.g, final.N


def sqrt_pkfs(
    lgssm: LGSSM,
    observations: Array,
    return_loglikelihood: bool = False,
    sqQ: Array | None = None,
    sqP0: Array | None = None,
):
    """Square-root parallel filter + smoother (cf. parallel.pkfs): smoothed
    means + covariance factors[, LML]."""
    if return_loglikelihood:
        fms, fUs, ell = sqrt_pkf(lgssm, observations, True, sqQ, sqP0)
    else:
        fms, fUs = sqrt_pkf(lgssm, observations, False, sqQ, sqP0)
    gms, gNs = sqrt_pks(lgssm, fms, fUs, sqQ)
    if return_loglikelihood:
        return gms, gNs, ell
    return gms, gNs


def kernel_sq_factors(kernel, ts: Array, lgssm: LGSSM, nodes: int | None, t0):
    """(sqQ, sqP0) for a kernel: entrywise-accurate quadrature Gramian
    factors where the kernel has a rank-1 dispersion (every companion-form
    base kernel); eigh factors of the assembled planes otherwise (Sum /
    Product composites carry block or full-rank L — the quadrature
    construction does not apply)."""
    d = kernel.state_dim
    if nodes is None:
        nodes = max(8, d + 2)
    dts = jnp.diff(
        ts[:, 0], prepend=jnp.asarray(t0, ts.dtype).reshape(1)
    )
    try:
        sqQ = gramian_disc_factors(kernel, dts, nodes)
    except ValueError:
        sqQ = None
    return sqQ, psd_sqrt(lgssm.P0)


def sqrt_pkfs_kernel(
    kernel,
    ts: Array,
    R,
    observations: Array,
    return_loglikelihood: bool = False,
    nodes: int | None = None,
    t0=0.0,
):
    """Square-root filter + smoother straight from a kernel (cf.
    sqrt_pkf_kernel): the model's ``stable=True`` prediction path."""
    ts = jnp.asarray(ts).reshape(-1, 1)
    R = jnp.asarray(R).reshape(1, 1)
    lgssm = kernel.get_ssm(ts, R, t0)
    sqQ, sqP0 = kernel_sq_factors(kernel, ts, lgssm, nodes, t0)
    return sqrt_pkfs(
        lgssm, observations, return_loglikelihood, sqQ=sqQ, sqP0=sqP0
    )


# ---------------------------------------------------------------------------
# Fisher-identity LML on the square-root engine (differentiable stable path)
# ---------------------------------------------------------------------------
#
# Autodiff THROUGH the sqrt scan is a dead end: jnp.linalg.qr's VJP divides
# by the R-factor diagonal, and the information factors Z are rank-m BY
# CONSTRUCTION (J = (HF)ᵀS⁻¹(HF) has rank m), so every training gradient is
# NaN regardless of conditioning.  Instead the gradient uses Fisher's
# identity exactly like the plane engines (kalman/timelast.py::lml_tl, the
# same CONTRACT: exact for stationarity-consistent SSMs, which
# ops.disc/get_ssm guarantee): backward = one SQUARE-ROOT smoother pass +
# elementwise formulas.  Every inversion in the tail is a triangular solve
# against a per-step predicted-covariance FACTOR Ψ11 (cond(Ψ11) =
# √cond(Pp)), so the backward inherits the forward's stability margin —
# nothing in the path factorizes or inverts an assembled graded matrix.
#
# ``sqQ``/``sqP0`` receive ZERO cotangents: they are exact factorizations
# of Qs/P0, so the full dℓ/dθ is already carried by the (Qs, P0) cotangents
# (assigning it to both would double-count).


def _sqrt_fisher_bwd(lgssm, observations, fms, fUs, sqQ, sqP0, gbar):
    from jax.scipy.linalg import solve_triangular

    P0, Fs, Qs, H, R = lgssm
    dtype = P0.dtype
    d = P0.shape[0]
    T = Fs.shape[0]
    h = H[0]
    r = R[0, 0]

    gms, gNs = sqrt_pks(lgssm, fms, fUs, sqQ)

    ys = observations.reshape(T)
    mask = jnp.logical_not(jnp.isnan(ys))
    y = jnp.where(mask, jnp.nan_to_num(ys), 0.0)
    maskf = mask.astype(dtype)

    sqQ_ = psd_sqrt(Qs) if sqQ is None else sqQ
    k = sqQ_.shape[-1]
    if k < d:
        sqQ_ = jnp.concatenate(
            [sqQ_, jnp.zeros((T, d, d - k), dtype)], axis=-1
        )
    sqP0_ = psd_sqrt(P0) if sqP0 is None else sqP0
    if sqP0_.shape[-1] != d:
        sqP0_ = tria(sqP0_)

    # Per-step predicted-covariance factors Ψ11_k = tria([F_k U_{k−1}, G_k])
    # (U₋₁ = √P0), V_k = F_k U_{k−1}:  Pp_k = V Vᵀ + G Gᵀ = Ψ11 Ψ11ᵀ.
    U_prev = jnp.concatenate([sqP0_[None], fUs[:-1]], axis=0)
    m_prev = jnp.concatenate(
        [jnp.zeros((1, d), dtype), fms[:-1]], axis=0
    )
    V = Fs @ U_prev
    Psi11 = tria(jnp.concatenate([V, sqQ_], axis=-1))  # (T, d, d)

    def fsolve(B):
        """Pp⁻¹ B via two triangular solves on the factor."""
        return solve_triangular(
            jnp.swapaxes(Psi11, -1, -2),
            solve_triangular(Psi11, B, lower=True),
            lower=False,
        )

    I = jnp.broadcast_to(jnp.eye(d, dtype=dtype), (T, d, d))
    Ppinv = fsolve(I)
    delta = gms - _mv(Fs, m_prev)  # m̂_k − mp_k
    rk = fsolve(delta[..., None])[..., 0]  # Pp⁻¹ δ
    W = fsolve(gNs)  # Pp⁻¹ N̂
    # Pp⁻¹ D Pp⁻¹ = W Wᵀ − Pp⁻¹;  Pp⁻¹ D = W N̂ᵀ − I  (D = P̂ − Pp)
    PiDPi = W @ jnp.swapaxes(W, -1, -2) - Ppinv
    PiD = W @ jnp.swapaxes(gNs, -1, -2) - I

    # RTS gains E_{k−1} = P_{k−1} F_kᵀ Pp_k⁻¹ = U_prev (Pp⁻¹ V)ᵀ and the
    # pre-initial smoothed mean m̂₋₁ = E₋₁ m̂₀ (mp₀ = 0).
    E_prev = U_prev @ jnp.swapaxes(fsolve(V), -1, -2)
    mham1 = _mv(E_prev[0], gms[0])
    mh_prev = jnp.concatenate([mham1[None], gms[:-1]], axis=0)

    dQ = 0.5 * (PiDPi + rk[:, :, None] * rk[:, None, :])
    dF = rk[:, :, None] * mh_prev[:, None, :] + PiD @ jnp.swapaxes(
        E_prev, -1, -2
    )
    dP0 = Fs[0].T @ dQ[0] @ Fs[0]

    # Observation terms (m = 1; cf. timelast.fisher_grads_from_smoothed).
    Hm = gms @ h  # (T,)
    resid = y - Hm
    hN = jnp.swapaxes(gNs, -1, -2) @ h  # (T, d): N̂ᵀ h
    HPhat = _mv(gNs, hN)  # (T, d): P̂ h
    dH = (
        jnp.sum(maskf[:, None] * (resid[:, None] * gms - HPhat), axis=0)
        / r
    )[None, :]
    HPH = jnp.sum(hN * hN, axis=-1)  # (T,) — ≥ 0 by construction
    Nk = resid * resid + HPH
    dR = jnp.sum(0.5 * maskf * (Nk / (r * r) - 1.0 / r)).reshape(1, 1)
    dy = jnp.where(mask, -resid / r, 0.0).reshape(observations.shape)

    g = gbar.astype(dtype)
    zero_sqQ = None if sqQ is None else jnp.zeros_like(sqQ)
    zero_sqP0 = None if sqP0 is None else jnp.zeros_like(sqP0)
    return (
        LGSSM(g * dP0, g * dF, g * dQ, g * dH, g * dR),
        g * dy,
        zero_sqQ,
        zero_sqP0,
    )


@jax.custom_vjp
def sqrt_lml(lgssm: LGSSM, observations: Array, sqQ=None, sqP0=None):
    """LML through the square-root filter with Fisher-identity gradients —
    the differentiable stable path (training/MCMC at conditionings where
    the standard f32 engines fail; see section comment)."""
    _, _, ell = sqrt_pkf(lgssm, observations, True, sqQ, sqP0)
    return ell


def _sqrt_lml_fwd(lgssm, observations, sqQ, sqP0):
    fms, fUs, ell = sqrt_pkf(lgssm, observations, True, sqQ, sqP0)
    return ell, (lgssm, observations, fms, fUs, sqQ, sqP0)


def _sqrt_lml_bwd(residuals, gbar):
    lgssm, observations, fms, fUs, sqQ, sqP0 = residuals
    with jax.default_matmul_precision("float32"):
        return _sqrt_fisher_bwd(
            lgssm, observations, fms, fUs, sqQ, sqP0, gbar
        )


sqrt_lml.defvjp(_sqrt_lml_fwd, _sqrt_lml_bwd)


def sqrt_lml_kernel(
    kernel, ts: Array, R, observations: Array,
    nodes: int | None = None, t0=0.0,
):
    """Differentiable stable LML straight from a kernel: gradients flow to
    the hyperparameters through the discretization's own VJP (closed-form
    planes), while the factor inputs are ``stop_gradient``-ed — their
    cotangents are zero by construction (see section comment), and cutting
    them keeps eigh's degenerate-eigenvalue VJP out of the graph."""
    ts = jnp.asarray(ts).reshape(-1, 1)
    R = jnp.asarray(R).reshape(1, 1)
    lgssm = kernel.get_ssm(ts, R, t0)
    sqQ, sqP0 = kernel_sq_factors(kernel, ts, lgssm, nodes, t0)
    sqQ = None if sqQ is None else jax.lax.stop_gradient(sqQ)
    return sqrt_lml(
        lgssm, observations, sqQ, jax.lax.stop_gradient(sqP0)
    )
