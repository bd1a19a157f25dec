"""Small-matrix linear-algebra helpers shared by the Kalman engines.

All functions are shape-polymorphic over leading batch dimensions so that a
single implementation serves the per-step (d, d) path, the vectorized
(T, d, d) path, and vmapped batches of GPs.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import Array


def mm(a: Array, b: Array) -> Array:
    """``a @ b`` at full float32 precision, batched over leading dims.

    At the default precision XLA may run a float32 matmul on a GPU in TF32
    (10 mantissa bits), which is too coarse for covariance algebra.  Every
    product here is (d, d)-sized, so full precision costs nothing."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def symmetrize(P: Array) -> Array:
    """0.5 (P + Pᵀ) over the trailing two axes.

    The reference symmetrizes covariances after every predict/update to fight
    float drift (reference: pssgp/kalman/sequential.py:21,39,61;
    parallel.py:116-117,165); we keep the same discipline.
    """
    return 0.5 * (P + jnp.swapaxes(P, -1, -2))


def inv_small(M: Array) -> Array:
    """Closed-form (adjugate) inverse for trailing dims 1/2/3, batched.

    The associative-scan combine solves (d, d) systems with d = SDE state
    dimension — typically 1-3 (Matérn family).  Batched LU over (T, d, d) is
    latency-bound (serialized pivoting on tiny matrices); the adjugate form
    is pure elementwise work that XLA fuses into the surrounding combine.
    Falls back to LU for d > 3 (RBF/Periodic/composite kernels).
    """
    d = M.shape[-1]
    if d == 1:
        return 1.0 / M
    if d == 2:
        a = M[..., 0, 0]
        b = M[..., 0, 1]
        c = M[..., 1, 0]
        e = M[..., 1, 1]
        det = a * e - b * c
        adj = jnp.stack(
            [
                jnp.stack([e, -b], axis=-1),
                jnp.stack([-c, a], axis=-1),
            ],
            axis=-2,
        )
        return adj / det[..., None, None]
    if d == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        e, f, g = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        h, i, j = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
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
                jnp.stack([A00, A01, A02], axis=-1),
                jnp.stack([A10, A11, A12], axis=-1),
                jnp.stack([A20, A21, A22], axis=-1),
            ],
            axis=-2,
        )
        return adj / det[..., None, None]
    return jnp.linalg.inv(M)


def solve_small(M: Array, B: Array) -> Array:
    """``inv(M) @ B`` with the closed-form fast path for d ≤ 3."""
    if M.shape[-1] <= 3:
        return mm(inv_small(M), B)
    return jnp.linalg.solve(M, B)


def solve_right(M: Array, A: Array) -> Array:
    """Return ``A @ inv(M)`` via a transposed solve, batched over leading dims.

    Equivalent to the reference's ``tf.linalg.solve(M, Aᵀ, adjoint=True)ᵀ``
    pattern (reference: pssgp/kalman/parallel.py:107,112).
    """
    return jnp.swapaxes(
        jnp.linalg.solve(jnp.swapaxes(M, -1, -2), jnp.swapaxes(A, -1, -2)),
        -1,
        -2,
    )


def cho_solve_psd(S: Array, B: Array) -> Array:
    """Solve ``S X = B`` for symmetric positive-definite S via Cholesky.

    Batched over leading dimensions. Mirrors ``tf.linalg.cholesky_solve``
    usage in the reference hot loops (e.g. pssgp/kalman/sequential.py:29).
    """
    if S.shape[-1] == 1:  # scalar innovation — the common 1-D-observation case
        return B / S
    chol = jnp.linalg.cholesky(S)
    # Two triangular solves: L z = B, then Lᵀ x = z.
    from jax.scipy.linalg import solve_triangular

    z = solve_triangular(chol, B, lower=True)
    return solve_triangular(jnp.swapaxes(chol, -1, -2), z, lower=False)


def mvn_logpdf(y: Array, mean: Array, cov: Array) -> Array:
    """Log-density of N(mean, cov) at y, batched over leading dims.

    y, mean: (..., k); cov: (..., k, k). Uses Cholesky like the reference's
    ``MultivariateNormalTriL.log_prob`` (pssgp/kalman/sequential.py:27-28).
    """
    k = y.shape[-1]
    if k == 1:  # scalar observation fast path (no batched Cholesky kernel)
        var = cov[..., 0, 0]
        diff = y[..., 0] - mean[..., 0]
        return -0.5 * (
            diff * diff / var + jnp.log(var) + math.log(2.0 * math.pi)
        )
    chol = jnp.linalg.cholesky(cov)
    from jax.scipy.linalg import solve_triangular

    diff = (y - mean)[..., None]
    z = solve_triangular(chol, diff, lower=True)[..., 0]
    quad = jnp.sum(z * z, axis=-1)
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol, axis1=-2, axis2=-1)), axis=-1
    )
    return -0.5 * (quad + logdet + k * math.log(2.0 * math.pi))
