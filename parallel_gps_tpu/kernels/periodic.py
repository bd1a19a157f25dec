"""(Quasi-)periodic kernel as an order-N harmonic-oscillator SDE.

Implements the Solin–Särkkä expansion of the periodic squared-exponential
kernel (reference: pssgp/kernels/periodic.py).  The state stacks N+1
deterministic oscillators at frequencies j·ω₀ (Q = 0); the stationary
covariance carries the Bessel-series weights q²_j.

Note the reference applies a factor-2 lengthscale shim to convert from
GPflow's periodic convention σ² exp(−0.5 sin²(πτ/p)/ℓ²) to the canonical
σ² exp(−2 sin²(ω₀τ/2)/ℓ'²) with ℓ' = 2ℓ (reference: periodic.py:57); we do
the same so the dense and state-space forms agree.
"""
from __future__ import annotations

import math
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
from jax import Array

from parallel_gps_tpu import config, pytree
from parallel_gps_tpu.kernels.base import SDEKernel
from parallel_gps_tpu.types import ContinuousDiscreteModel


@lru_cache(maxsize=None)
def _offline_coeffs(N: int):
    """Parameter-independent coefficients b, K, 1/K!
    (reference: pssgp/kernels/periodic.py:18-38)."""
    r = np.arange(0, N + 1)
    J, K = np.meshgrid(r, r)
    div_facto_K = 1.0 / np.vectorize(math.factorial)(K)
    b = (
        2.0
        * np.vectorize(math.comb)(K, (np.floor((K - J) / 2) * (J <= K)).astype(int))
        / (1.0 + (J == 0))
        * (J <= K)
        * (np.mod(K - J, 2) == 0)
    )
    return b.astype(np.float64), K.astype(np.float64), div_facto_K.astype(np.float64)


@pytree.dataclass
class Periodic(SDEKernel):
    """Periodic kernel with SquaredExponential base (GPflow convention)."""

    variance: Array = 1.0
    lengthscales: Array = 1.0
    period: Array = 1.0
    order: int = pytree.field(pytree_node=False, default=6)

    @property
    def state_dim(self) -> int:
        return 2 * (self.order + 1)

    def get_sde(self) -> ContinuousDiscreteModel:
        dtype = config.default_float()
        N = self.order
        period = jnp.asarray(self.period, dtype)
        w0 = 2.0 * math.pi / period
        # GPflow-convention shim (see module docstring).
        ell = 2.0 * jnp.asarray(self.lengthscales, dtype)
        var = jnp.asarray(self.variance, dtype)

        b_, K_, div_facto_K_ = _offline_coeffs(N)
        b = jnp.asarray(b_, dtype)
        K = jnp.asarray(K_, dtype)
        div_facto_K = jnp.asarray(div_facto_K_, dtype)

        rot = jnp.array([[0.0, -1.0], [1.0, 0.0]], dtype)
        F = jnp.kron(jnp.diag(jnp.arange(0, N + 1, dtype=dtype)), w0 * rot)

        dim = 2 * (N + 1)
        L = jnp.eye(dim, dtype=dtype)
        Q = jnp.zeros((dim, dim), dtype)

        q2 = (
            b
            * ell ** (-2.0 * K)
            * div_facto_K
            * jnp.exp(-(ell**-2.0))
            * 2.0 ** (-K)
            * var
        )
        q2 = jnp.sum(q2, axis=0)
        Pinf = jnp.kron(jnp.diag(q2), jnp.eye(2, dtype=dtype))

        H = jnp.kron(
            jnp.ones((1, N + 1), dtype), jnp.asarray([[1.0, 0.0]], dtype)
        )
        return ContinuousDiscreteModel(Pinf, F, L, H, Q)

    def transitions_m1(self, dts: Array):
        """Exact closed form: F is a direct sum of plane-rotation generators
        j·ω₀·[[0,−1],[1,0]], so expm(dt F) − I is the direct sum of
        [[cosθ−1, −sinθ], [sinθ, cosθ−1]] with θ_j = j·ω₀·dt; the diagonal
        uses the half-angle identity cosθ − 1 = −2 sin²(θ/2), which is
        cancellation-free at tiny dt."""
        dtype = dts.dtype
        N = self.order
        w0 = 2.0 * math.pi / jnp.asarray(self.period, dtype)
        j = jnp.arange(N + 1, dtype=dtype)
        theta = dts[:, None] * (w0 * j)[None, :]  # (T, N+1)
        cm1 = -2.0 * jnp.sin(0.5 * theta) ** 2
        s = jnp.sin(theta)
        T = dts.shape[0]
        dim = 2 * (N + 1)
        ev = jnp.arange(N + 1) * 2
        out = jnp.zeros((T, dim, dim), dtype)
        out = out.at[:, ev, ev].set(cm1)
        out = out.at[:, ev, ev + 1].set(-s)
        out = out.at[:, ev + 1, ev].set(s)
        out = out.at[:, ev + 1, ev + 1].set(cm1)
        return out

    def transitions_m1_tl(self, dts: Array):
        """Time-last rotation planes, assembled directly as (d, d, T): each
        (i, j) entry is a (T,) plane — composite discretization through
        :meth:`SDEKernel.get_ssm_tl` never materializes the batched
        (T, d, d) layout (the expm1_dt_tl rationale, ops/expm.py)."""
        dtype = dts.dtype
        N = self.order
        w0 = 2.0 * math.pi / jnp.asarray(self.period, dtype)
        j = jnp.arange(N + 1, dtype=dtype)
        theta = (w0 * j)[:, None] * dts[None, :]  # (N+1, T)
        cm1 = -2.0 * jnp.sin(0.5 * theta) ** 2
        s = jnp.sin(theta)
        T = dts.shape[0]
        dim = 2 * (N + 1)
        ev = jnp.arange(N + 1) * 2
        out = jnp.zeros((dim, dim, T), dtype)
        out = out.at[ev, ev, :].set(cm1)
        out = out.at[ev, ev + 1, :].set(-s)
        out = out.at[ev + 1, ev, :].set(s)
        out = out.at[ev + 1, ev + 1, :].set(cm1)
        return out

    def transition_coeffs(self):
        """Closed form (see SDEKernel.transition_coeffs): one coefficient
        (ω₀); the build emits the rotation planes of :meth:`transitions_m1`
        with elementwise sin only (cosθ − 1 = −2 sin²(θ/2)).  The j = 0 oscillator is the identity
        (Am1 block exactly zero), so its entries stay None (structural
        zeros, kernels.base.zmul)."""
        dtype = config.default_float()
        w0 = 2.0 * math.pi / jnp.asarray(self.period, dtype)
        coeffs = w0.reshape(1)
        N = self.order
        dim = 2 * (N + 1)

        def build(c, dt):
            rows = [[None] * dim for _ in range(dim)]
            for j in range(1, N + 1):
                theta = (float(j) * c[0]) * dt
                cm1 = -2.0 * jnp.sin(0.5 * theta) ** 2
                s = jnp.sin(theta)
                e = 2 * j
                rows[e][e] = cm1
                rows[e][e + 1] = -s
                rows[e + 1][e] = s
                rows[e + 1][e + 1] = cm1
            return rows

        return coeffs, build

    def dense(self, X: Array, X2: Array) -> Array:
        tau = X.reshape(-1, 1) - X2.reshape(-1, 1).T
        s = jnp.sin(math.pi * tau / self.period) / self.lengthscales
        return self.variance * jnp.exp(-0.5 * s**2)
