"""Matérn half-integer kernel family as LTI SDEs.

SDE construction follows the classical companion-form representation
(reference: pssgp/kernels/matern/common.py:10-52): for smoothness ν = d − 1/2,
λ = √(2d−1)/ℓ, F has ones on the superdiagonal and last row
−binom(d,k) λ^{d−k}; L = e_d, H = e_1ᵀ, and spectral density
q = (2λ)^{2d−1} σ² ((d−1)!)² / (2d−2)!.

Matern12/Matern32 use closed-form stationary covariances (reference:
matern12.py:18-23, matern32.py:20-28); Matern52 balances and solves the
Lyapunov equation (reference: matern52.py:21-25).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu import config, pytree
from parallel_gps_tpu.kernels.base import SDEKernel, scaled_dist
from parallel_gps_tpu.ops.balance import balance_scale, balance_ss
from parallel_gps_tpu.ops.linalg import mm
from parallel_gps_tpu.ops.lyapunov import solve_lyap_vec
from parallel_gps_tpu.types import ContinuousDiscreteModel


def matern_sde(variance, lengthscales, d: int):
    """(F, L, H, Q) of the order-d Matérn SDE (see module docstring)."""
    dtype = config.default_float()
    variance = jnp.asarray(variance, dtype)
    lengthscales = jnp.asarray(lengthscales, dtype)
    lam = math.sqrt(2 * d - 1) / lengthscales

    F = jnp.diag(jnp.ones((d - 1,), dtype), k=1) if d > 1 else jnp.zeros((1, 1), dtype)
    binoms = jnp.asarray([math.comb(d, k) for k in range(d)], dtype)
    lam_powers = lam ** jnp.arange(d, 0, -1, dtype=dtype)
    F = F.at[d - 1, :].add(-binoms * lam_powers)

    L = jnp.zeros((d, 1), dtype).at[d - 1, 0].set(1.0)
    H = jnp.zeros((1, d), dtype).at[0, 0].set(1.0)
    q = (
        (2.0 * lam) ** (2 * d - 1)
        * variance
        * math.factorial(d - 1) ** 2
        / math.factorial(2 * d - 2)
    )
    Q = q.reshape(1, 1)
    return F, L, H, Q


def exppoly_transition_coeffs(d: int, lam, N_powers):
    """(coeffs, build) for the exponential-polynomial transition family

        expm(dt·F) − I = expm1(−λ dt)·I + e^{−λ dt} Σ_{p=1..deg} dt^p/p! · N_p

    (F with a single eigenvalue −λ of multiplicity d and nilpotent shift
    N = F + λI, N_p = Nᵖ, optionally balance-scaled) — every Matérn
    half-integer kernel, and closed under products of Matérns (λ's add,
    polynomials Kronecker-multiply).  ``build`` meets the
    SDEKernel.transition_coeffs contract: elementwise-only, no captured
    tracers (d/degree are static)."""
    degree = len(N_powers)
    coeffs = jnp.concatenate(
        [jnp.reshape(lam, (1,))] + [jnp.reshape(N, (-1,)) for N in N_powers]
    )

    def build(c, dt):
        lam_ = c[0]
        em1 = jnp.expm1(-lam_ * dt)
        rows = [
            [em1 if i == j else jnp.zeros_like(dt) for j in range(d)]
            for i in range(d)
        ]
        if degree:
            term = jnp.exp(-lam_ * dt) * dt
            for p in range(1, degree + 1):
                off = 1 + (p - 1) * d * d
                for i in range(d):
                    for j in range(d):
                        rows[i][j] = rows[i][j] + term * c[off + i * d + j]
                if p < degree:
                    term = term * dt * (1.0 / (p + 1))
        return rows

    return coeffs, build


@pytree.dataclass
class Matern12(SDEKernel):
    variance: Array = 1.0
    lengthscales: Array = 1.0

    @property
    def state_dim(self) -> int:
        return 1

    def get_sde(self) -> ContinuousDiscreteModel:
        F, L, H, Q = matern_sde(self.variance, self.lengthscales, 1)
        Pinf = jnp.asarray(self.variance, F.dtype).reshape(1, 1)
        return ContinuousDiscreteModel(Pinf, F, L, H, Q)

    def transitions_m1(self, dts: Array):
        """expm(−λ dt) − 1 = expm1(−λ dt) — scalar OU transition, exact and
        cancellation-free."""
        lam = 1.0 / jnp.asarray(self.lengthscales, dts.dtype)
        return jnp.expm1(-lam * dts)[:, None, None]

    def transitions_m1_tl(self, dts: Array):
        lam = 1.0 / jnp.asarray(self.lengthscales, dts.dtype)
        return jnp.expm1(-lam * dts)[None, None, :]

    def transition_coeffs(self):
        dtype = config.default_float()
        lam = 1.0 / jnp.asarray(self.lengthscales, dtype)
        return exppoly_transition_coeffs(1, lam, [])

    def dense(self, X: Array, X2: Array) -> Array:
        r = scaled_dist(X, X2, self.lengthscales)
        return self.variance * jnp.exp(-r)


@pytree.dataclass
class Matern32(SDEKernel):
    variance: Array = 1.0
    lengthscales: Array = 1.0

    @property
    def state_dim(self) -> int:
        return 2

    def get_sde(self) -> ContinuousDiscreteModel:
        F, L, H, Q = matern_sde(self.variance, self.lengthscales, 2)
        dtype = F.dtype
        lam = math.sqrt(3) / jnp.asarray(self.lengthscales, dtype)
        var = jnp.asarray(self.variance, dtype)
        Pinf = jnp.diag(jnp.stack([var, lam**2 * var]))
        return ContinuousDiscreteModel(Pinf, F, L, H, Q)

    def transitions_m1(self, dts: Array):
        """Exact closed form: F has the double eigenvalue −λ, so with the
        nilpotent N = F + λI (N² = 0), expm(tF) = e^{−λt}(I + tN) and

            expm(tF) − I = expm1(−λt)·I + e^{−λt}·t·N,

        both terms O(t) — no cancellation at tiny dt."""
        lam = math.sqrt(3) / jnp.asarray(self.lengthscales, dts.dtype)
        t = dts
        em1 = jnp.expm1(-lam * t)
        et = jnp.exp(-lam * t) * t
        # N = [[λ, 1], [−λ², −λ]]
        row0 = jnp.stack([em1 + et * lam, et], axis=-1)
        row1 = jnp.stack([-et * lam**2, em1 - et * lam], axis=-1)
        return jnp.stack([row0, row1], axis=-2)

    def transitions_m1_tl(self, dts: Array):
        """Same closed form, assembled time-last: each (i, j) entry is a
        (T,) plane, so the (2, 2, T) stack is relayout-free."""
        lam = math.sqrt(3) / jnp.asarray(self.lengthscales, dts.dtype)
        t = dts
        em1 = jnp.expm1(-lam * t)
        et = jnp.exp(-lam * t) * t
        row0 = jnp.stack([em1 + et * lam, et], axis=0)  # (2, T)
        row1 = jnp.stack([-et * lam**2, em1 - et * lam], axis=0)
        return jnp.stack([row0, row1], axis=0)  # (2, 2, T)

    def transition_coeffs(self):
        dtype = config.default_float()
        lam = math.sqrt(3) / jnp.asarray(self.lengthscales, dtype)
        # N = F + λI = [[λ, 1], [−λ², −λ]]
        one = jnp.ones((), dtype)
        N = jnp.stack(
            [
                jnp.stack([lam, one]),
                jnp.stack([-lam * lam, -lam]),
            ]
        )
        return exppoly_transition_coeffs(2, lam, [N])

    def dense(self, X: Array, X2: Array) -> Array:
        r = math.sqrt(3) * scaled_dist(X, X2, self.lengthscales)
        return self.variance * (1.0 + r) * jnp.exp(-r)


@pytree.dataclass
class Matern52(SDEKernel):
    variance: Array = 1.0
    lengthscales: Array = 1.0
    balancing_iter: int = pytree.field(pytree_node=False, default=-1)

    @property
    def state_dim(self) -> int:
        return 3

    def get_sde(self) -> ContinuousDiscreteModel:
        F, L, H, Q = matern_sde(self.variance, self.lengthscales, 3)
        n_iter = (
            self.balancing_iter
            if self.balancing_iter >= 0
            else config.NUMBER_OF_BALANCING_STEPS
        )
        Fb, Lb, Hb, Qb = balance_ss(F, L, H, Q, n_iter)
        Pinf = solve_lyap_vec(Fb, Lb, Qb)
        return ContinuousDiscreteModel(Pinf, Fb, Lb, Hb, Qb)

    def transitions_m1(self, dts: Array):
        """Exact closed form: the companion F has the triple eigenvalue −λ,
        so with nilpotent N = F + λI (N³ = 0),

            expm(tF) − I = expm1(−λt)·I + e^{−λt}(tN + t²N²/2),

        all terms O(t); get_sde balances F by a diagonal similarity D, and
        (expm(D⁻¹FD) − I) = D⁻¹(expm(F·t) − I)D."""
        F, _, _, _ = matern_sde(self.variance, self.lengthscales, 3)
        dtype = dts.dtype
        lam = math.sqrt(5) / jnp.asarray(self.lengthscales, dtype)
        eye = jnp.eye(3, dtype=dtype)
        N = F.astype(dtype) + lam * eye
        N2 = mm(N, N)
        t = dts[:, None, None]
        Em1 = jnp.expm1(-lam * t) * eye + jnp.exp(-lam * t) * (
            t * N + 0.5 * t * t * N2
        )
        n_iter = (
            self.balancing_iter
            if self.balancing_iter >= 0
            else config.NUMBER_OF_BALANCING_STEPS
        )
        d = jax.lax.stop_gradient(balance_scale(F, n_iter)).astype(dtype)
        return Em1 * (d[None, None, :] / d[None, :, None])

    def transitions_m1_tl(self, dts: Array):
        """Time-last variant of :meth:`transitions_m1`: t is the last axis."""
        F, _, _, _ = matern_sde(self.variance, self.lengthscales, 3)
        dtype = dts.dtype
        lam = math.sqrt(5) / jnp.asarray(self.lengthscales, dtype)
        eye = jnp.eye(3, dtype=dtype)
        N = F.astype(dtype) + lam * eye
        N2 = mm(N, N)
        t = dts[None, None, :]  # (1, 1, T)
        Em1 = jnp.expm1(-lam * t) * eye[:, :, None] + jnp.exp(-lam * t) * (
            t * N[:, :, None] + 0.5 * t * t * N2[:, :, None]
        )
        n_iter = (
            self.balancing_iter
            if self.balancing_iter >= 0
            else config.NUMBER_OF_BALANCING_STEPS
        )
        d = jax.lax.stop_gradient(balance_scale(F, n_iter)).astype(dtype)
        return Em1 * (d[None, :, None] / d[:, None, None])

    def transition_coeffs(self):
        dtype = config.default_float()
        F, _, _, _ = matern_sde(self.variance, self.lengthscales, 3)
        lam = math.sqrt(5) / jnp.asarray(self.lengthscales, dtype)
        N = F.astype(dtype) + lam * jnp.eye(3, dtype=dtype)
        N2 = mm(N, N)
        n_iter = (
            self.balancing_iter
            if self.balancing_iter >= 0
            else config.NUMBER_OF_BALANCING_STEPS
        )
        dvec = jax.lax.stop_gradient(balance_scale(F, n_iter)).astype(dtype)
        scale = dvec[None, :] / dvec[:, None]  # [i, j] = d_j / d_i
        return exppoly_transition_coeffs(3, lam, [N * scale, N2 * scale])

    def dense(self, X: Array, X2: Array) -> Array:
        r = math.sqrt(5) * scaled_dist(X, X2, self.lengthscales)
        return self.variance * (1.0 + r + r**2 / 3.0) * jnp.exp(-r)
