"""Dense Gaussian-process regression — the correctness oracle.

The reference anchors its parity tests on GPflow's ``GPR``
(reference: tests/test_gp_vs_kfs.py:49-56).  This is our own ~80-line dense GP
with identical math (zero mean function), sharing the *same kernel pytrees* as
the state-space model so LML values and gradients are directly comparable.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
from jax import Array
from jax.scipy.linalg import cho_factor, cho_solve

from parallel_gps_tpu import pytree
from parallel_gps_tpu.kernels.base import SDEKernel
from parallel_gps_tpu.ops.linalg import mm


@pytree.dataclass
class GPR:
    ts: Array  # (N, 1)
    ys: Array  # (N, 1)
    kernel: SDEKernel
    noise_variance: Array

    def log_marginal_likelihood(self) -> Array:
        X, Y = self.ts, self.ys
        n = X.shape[0]
        K = self.kernel.dense(X, X) + self.noise_variance * jnp.eye(
            n, dtype=X.dtype
        )
        chol, lower = cho_factor(K, lower=True)
        alpha = cho_solve((chol, lower), Y)
        quad = jnp.sum(Y * alpha)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diag(chol)))
        return -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))

    def predict_f(self, Xnew: Array):
        X, Y = self.ts, self.ys
        n = X.shape[0]
        K = self.kernel.dense(X, X) + self.noise_variance * jnp.eye(
            n, dtype=X.dtype
        )
        Ks = self.kernel.dense(X, Xnew)  # (N, M)
        chol, lower = cho_factor(K, lower=True)
        alpha = cho_solve((chol, lower), Y)
        mean = mm(Ks.T, alpha)  # (M, 1)
        v = cho_solve((chol, lower), Ks)
        Kss = self.kernel.dense(Xnew, Xnew)
        var = jnp.diag(Kss - mm(Ks.T, v))[:, None]
        return mean, var
