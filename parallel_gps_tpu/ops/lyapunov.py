"""Vectorized continuous Lyapunov solver.

Solves F P + P Fᵀ + L Q Lᵀ = 0 for the stationary covariance P∞ by
vectorization: with row-major vec, (F ⊗ I + I ⊗ F) vec(P) = -vec(L Q Lᵀ).
Reference: pssgp/kernels/math_utils.py:84-120.  State dimensions are tiny
(d ≤ ~32 → d² ≤ ~1024), so the dense Kronecker solve is cheap and fully
differentiable.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu.ops.linalg import mm, symmetrize


def solve_lyap_vec(F: Array, L: Array, Q: Array) -> Array:
    dim = F.shape[0]
    eye = jnp.eye(dim, dtype=F.dtype)
    K = jnp.kron(eye, F) + jnp.kron(F, eye)
    rhs = mm(mm(L, Q), L.T).reshape(-1, 1)
    Pinf = jnp.linalg.solve(K, rhs).reshape(dim, dim)
    return -symmetrize(Pinf)
