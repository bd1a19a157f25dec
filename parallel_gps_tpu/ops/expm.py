"""Batched matrix exponential, built for XLA compilation.

``jax.scipy.linalg.expm`` under ``vmap`` is hostile to XLA: its norm-dependent
Padé-degree selection (``lax.cond``) lowers to computing *every* branch per
batch element, and its ``matrix_power`` squaring loop adds more; at T=10⁵+
time steps both compile and run time blow up.  The discretization step needs
``expm(dt_k · F)`` for T tiny (d ≤ ~32) matrices (reference:
pssgp/kernels/base.py:36-46), so this module implements one fixed program:

  - Padé-13 (Higham 2005) — a fixed sequence of 6 batched matmuls + one
    (d, d) solve (closed-form adjugate for d ≤ 3);
  - per-element scaling by 2^{-k_i} with k_i chosen elementwise from the
    1-norm, followed by MAX_SQUARINGS masked squarings (``where``-selected,
    no control flow), so any mix of step sizes compiles to one static graph.

Everything is differentiable (plain arithmetic + linear solve).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu.ops.linalg import mm, solve_small

# Padé-13 coefficients (Higham, "The scaling and squaring method for the
# matrix exponential revisited", 2005).
_B13 = (
    64764752532480000.0,
    32382376266240000.0,
    7771770303897600.0,
    1187353796428800.0,
    129060195264000.0,
    10559470521600.0,
    670442572800.0,
    33522128640.0,
    1323241920.0,
    40840800.0,
    960960.0,
    16380.0,
    182.0,
    1.0,
)
_THETA13 = 5.371920351148152  # ||A|| below which Padé-13 is accurate
MAX_SQUARINGS = 16  # covers ||A|| up to θ13·2^16 ≈ 3.5e5


def expm1_pade13(A: Array, max_squarings: int = MAX_SQUARINGS) -> Array:
    """``expm(A) − I`` over the trailing (d, d) axes, WITHOUT cancellation.

    The Padé-13 approximant is E = (V−U)⁻¹(V+U); subtracting I analytically,
    E − I = (V−U)⁻¹·2U — exact in floating point because U = A·(polynomial),
    i.e. O(‖A‖), so no large-minus-large subtraction happens even for
    ‖A‖ ~ 1e−6.  Squaring propagates the -minus-identity form stably via
    (E² − I) = (E−I)² + 2(E−I).

    This matters because the discretization needs ``Q_k = P − A P Aᵀ`` with
    A = I + O(dt): computing A first and subtracting loses ~eps/dt relative
    accuracy (everything, in f32, at dt ~ 1e−6), while the Am1 = A − I form
    keeps full precision (see ops/disc.py).
    """
    dtype = A.dtype
    d = A.shape[-1]
    eye = jnp.eye(d, dtype=dtype)

    # Per-element scaling: k_i = max(0, ceil(log2(norm/θ13))), capped.
    norm = jnp.max(jnp.sum(jnp.abs(A), axis=-1), axis=-1)  # 1-norm
    k = jnp.ceil(jnp.log2(jnp.maximum(norm / _THETA13, 1.0)))
    k = jnp.clip(k, 0, max_squarings)
    A = A * jnp.exp2(-k)[..., None, None].astype(dtype)

    A2 = mm(A, A)
    A4 = mm(A2, A2)
    A6 = mm(A2, A4)
    b = _B13
    W1 = b[13] * A6 + b[11] * A4 + b[9] * A2
    W2 = b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye
    U = mm(A, mm(A6, W1) + W2)
    Z1 = b[12] * A6 + b[10] * A4 + b[8] * A2
    V = mm(A6, Z1) + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye

    Em1 = solve_small(V - U, 2.0 * U)

    # Masked stable squaring of the minus-identity form.
    for j in range(max_squarings):
        sq = mm(Em1, Em1) + 2.0 * Em1
        Em1 = jnp.where((j < k)[..., None, None], sq, Em1)
    return Em1


def expm_pade13(A: Array, max_squarings: int = MAX_SQUARINGS) -> Array:
    """``expm`` over the trailing (d, d) axes, batched over leading axes."""
    d = A.shape[-1]
    return expm1_pade13(A, max_squarings) + jnp.eye(d, dtype=A.dtype)


def expm1_dt_tl(F: Array, dts: Array, max_squarings: int = MAX_SQUARINGS) -> Array:
    """``expm(dt_k · F) − I`` on TIME-LAST (d, d, T) planes.

    The batched (T, d, d) layout keeps every tiny matrix as its own padded
    tile in the compiler's layouts.  Here the time axis is the long one:
    matmuls are broadcast-multiply-reduce over (d, d, T) planes and the Padé
    solve uses the Schur-recursed time-last inverse (kalman/timelast._inv),
    so peak memory is ~10 d²·T planes of elementwise work.  Same cancellation-
    free minus-identity algebra as :func:`expm1_pade13`.
    """
    from parallel_gps_tpu.kalman.timelast import _inv, _mm

    dtype = F.dtype
    d = F.shape[-1]
    T = dts.shape[0]
    A = F[:, :, None] * dts[None, None, :]  # (d, d, T)
    eye_tl = jnp.broadcast_to(jnp.eye(d, dtype=dtype)[:, :, None], (d, d, T))

    norm = jnp.max(jnp.sum(jnp.abs(A), axis=1), axis=0)  # (T,) 1-norm
    k = jnp.ceil(jnp.log2(jnp.maximum(norm / _THETA13, 1.0)))
    k = jnp.clip(k, 0, max_squarings)
    A = A * jnp.exp2(-k)[None, None, :].astype(dtype)

    A2 = _mm(A, A)
    A4 = _mm(A2, A2)
    A6 = _mm(A2, A4)
    b = _B13
    W1 = b[13] * A6 + b[11] * A4 + b[9] * A2
    W2 = b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye_tl
    U = _mm(A, _mm(A6, W1) + W2)
    Z1 = b[12] * A6 + b[10] * A4 + b[8] * A2
    V = _mm(A6, Z1) + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye_tl

    # Normalize the solve by 1/b0 (~6.5e16): the Schur inverse's 3x3
    # adjugate base case forms determinants (products of three entries), and
    # unnormalized V-U entries of O(b0) overflow float32 (b0^3 ~ 1e50).
    inv_b0 = 1.0 / b[0]
    Em1 = _mm(_inv((V - U) * inv_b0), (2.0 * inv_b0) * U)
    for j in range(max_squarings):
        sq = _mm(Em1, Em1) + 2.0 * Em1
        Em1 = jnp.where((j < k)[None, None, :], sq, Em1)
    return Em1


def expm_dt_batched(F: Array, dts: Array, max_squarings: int = MAX_SQUARINGS) -> Array:
    """``expm(dt_k · F)`` for a (T,) vector of step sizes and one (d, d) F."""
    A = dts[:, None, None] * F[None]
    return expm_pade13(A, max_squarings)


def expm1_dt_batched(F: Array, dts: Array, max_squarings: int = MAX_SQUARINGS) -> Array:
    """``expm(dt_k · F) − I``, cancellation-free (see :func:`expm1_pade13`)."""
    A = dts[:, None, None] * F[None]
    return expm1_pade13(A, max_squarings)
