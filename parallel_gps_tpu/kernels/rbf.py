"""RBF / squared-exponential kernel via order-k Taylor SDE approximation.

The SE spectral density has no finite-dimensional SDE; following the
reference (pssgp/kernels/rbf.py:14-61), we Taylor-expand the inverse spectral
density to order k, find the stable (left-half-plane) roots of the resulting
polynomial at trace time in float64 numpy (parameter-independent), and build a
controllable companion form.  Lengthscale/variance scaling happens in-graph so
gradients flow (reference: pssgp/kernels/rbf.py:78-101).
"""
from __future__ import annotations

import math
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
from jax import Array

from parallel_gps_tpu import config, pytree
from parallel_gps_tpu.kernels.base import SDEKernel, scaled_dist
from parallel_gps_tpu.ops.balance import balance_scale, balance_ss
from parallel_gps_tpu.ops.lyapunov import solve_lyap_vec
from parallel_gps_tpu.types import ContinuousDiscreteModel


@lru_cache(maxsize=None)
def _unscaled_rbf_sde(order: int):
    """Parameter-independent SDE coefficients for the unit-lengthscale SE
    kernel (reference: pssgp/kernels/rbf.py:14-61). Pure numpy, trace-time."""
    B = math.sqrt(2.0 * math.pi)
    A = np.zeros((2 * order + 1,), dtype=np.float64)
    i = 0
    for k in range(order, -1, -1):
        A[i] = 0.5**k / math.factorial(k)
        i += 2

    q = B / np.polyval(A, 0)

    # Substitute s = iω: divide coefficient j (degree 2order-j) by i^degree.
    LA = np.real(A / (1j ** np.arange(A.size - 1, -1, -1)))
    AR = np.roots(LA)

    GB = 1.0
    GA = np.poly(AR[np.real(AR) < 0])
    GA = GA / GA[-1]
    GB = GB / GA[0]
    GA = GA / GA[0]

    n = GA.size - 1
    F = np.zeros((n, n), dtype=np.float64)
    F[-1, :] = -GA[:0:-1]
    F[:-1, 1:] = np.eye(n - 1)
    L = np.zeros((n, 1), dtype=np.float64)
    L[-1, 0] = 1.0
    H = np.zeros((1, n), dtype=np.float64)
    H[0, 0] = GB
    return F, L, H, float(q)


@lru_cache(maxsize=None)
def _rbf_spectral(order: int):
    """Trace-time spectral decomposition of the UNIT-lengthscale companion
    F(1): real/conjugate-pair eigenvalue blocks with their (real) spectral
    projector matrices, so that

        expm(u·F(1)) − I = Σ_real  expm1(α_k u)·G_k
                         + Σ_pairs [ (e^{α_k u}cos(β_k u) − 1)·G_k
                                     + e^{α_k u}sin(β_k u)·S_k ]

    with G_k = 2·Re(v_k w_kᵀ), S_k = −2·Im(v_k w_kᵀ) for a pair α_k ± iβ_k
    (G_k = Re(v_k w_kᵀ) for a real root), where v_k / w_k are right/left
    eigenvectors of F(1).  Σ_k G_k = I (resolution of identity), so every
    term is O(u) at small u when the diagonal is computed as
    expm1(αu)·cos(βu) − 2sin²(βu/2) — cancellation-free, like the Matérn
    nilpotent forms.  All data here is parameter-independent: lengthscale
    enters only through u = dt/ℓ and the diagonal similarity
    D = diag(ℓ⁻ⁱ) (reference: pssgp/kernels/rbf.py:89-94 — ℓ scales only
    the companion's last row, which IS that similarity plus the 1/ℓ time
    scale).  Returns a tuple of (alpha, beta, G, S) with S None for real
    roots; numpy float64.
    """
    F1, _, _, _ = _unscaled_rbf_sde(order)
    w, V = np.linalg.eig(F1)
    Winv = np.linalg.inv(V)
    blocks = []
    used = np.zeros(w.size, dtype=bool)
    for k in range(w.size):
        if used[k]:
            continue
        lam = w[k]
        P = np.outer(V[:, k], Winv[k, :])
        if abs(lam.imag) < 1e-10 * max(1.0, abs(lam.real)):
            blocks.append((float(lam.real), 0.0, np.real(P), None))
            used[k] = True
        else:
            if lam.imag < 0:
                lam = np.conj(lam)
                P = np.conj(P)
            blocks.append(
                (float(lam.real), float(lam.imag), 2.0 * P.real, -2.0 * P.imag)
            )
            used[k] = True
            conj_idx = np.where(
                ~used & (np.abs(w - np.conj(lam)) < 1e-8 * abs(lam))
            )[0]
            if conj_idx.size:
                used[conj_idx[0]] = True
    # Sanity: the projectors must resolve the identity to f64 roundoff.
    resid = np.abs(sum(b[2] for b in blocks) - np.eye(F1.shape[0])).max()
    if resid > 1e-6:
        raise ValueError(
            f"RBF order {order} spectral resolution residual {resid:.2e}"
        )
    return tuple(blocks)


# Spectral closed forms are used up to this order; beyond it the companion
# eigenvector conditioning degrades and the Padé path (ops/expm.py) is kept.
_SPECTRAL_MAX_ORDER = 8


@pytree.dataclass
class RBF(SDEKernel):
    variance: Array = 1.0
    lengthscales: Array = 1.0
    order: int = pytree.field(pytree_node=False, default=3)
    balancing_iter: int = pytree.field(pytree_node=False, default=-1)

    @property
    def state_dim(self) -> int:
        return self.order

    def _n_iter(self) -> int:
        return (
            self.balancing_iter
            if self.balancing_iter >= 0
            else config.NUMBER_OF_BALANCING_STEPS
        )

    def _scaled_F(self, dtype) -> Array:
        """The lengthscale-scaled companion F(ℓ) (in-graph scaling of the
        last row; reference: pssgp/kernels/rbf.py:89-91)."""
        F_, _, _, _ = _unscaled_rbf_sde(self.order)
        F = jnp.asarray(F_, dtype)
        dim = F.shape[0]
        ell = jnp.asarray(self.lengthscales, dtype)
        ell_vec = ell ** jnp.arange(dim, 0, -1, dtype=dtype)
        return F.at[dim - 1, :].set(F[dim - 1, :] / ell_vec)

    def get_sde(self) -> ContinuousDiscreteModel:
        dtype = config.default_float()
        _, L_, H_, q_ = _unscaled_rbf_sde(self.order)
        L = jnp.asarray(L_, dtype)
        H = jnp.asarray(H_, dtype)
        q = jnp.asarray(q_, dtype)

        F = self._scaled_F(dtype)
        dim = F.shape[0]
        ell = jnp.asarray(self.lengthscales, dtype)
        var = jnp.asarray(self.variance, dtype)

        H = H / (ell**dim)
        Q = (var * ell * q).reshape(1, 1)

        Fb, Lb, Hb, Qb = balance_ss(F, L, H, Q, self._n_iter())
        Pinf = solve_lyap_vec(Fb, Lb, Qb)
        return ContinuousDiscreteModel(Pinf, Fb, Lb, Hb, Qb.reshape(1, 1))

    def _kappa(self, dtype) -> Array:
        """Combined diagonal-similarity entry scale κ[i, j] mapping the
        unit-companion basis to get_sde's balanced basis:

            Am1_balanced[i, j] = κ[i, j] · (expm(u·F(1)) − I)[i, j],
            u = dt/ℓ,
            κ[i, j] = ℓ^{j−i} · db_j / db_i,

        where F(ℓ) = D F(1) D⁻¹ / ℓ with D = diag(ℓ⁻ⁱ) (the superdiagonal-1
        companion similarity) and db = balance_scale(F(ℓ)) is get_sde's
        stop-gradiented balancing scale (ops/balance.py: Fb = Db⁻¹ F Db)."""
        import jax

        dim = self.order
        ell = jnp.asarray(self.lengthscales, dtype)
        i = jnp.arange(dim, dtype=dtype)
        ell_pow = ell**i  # ℓ^{j−i} = ell_pow[j] / ell_pow[i]
        db = jax.lax.stop_gradient(
            balance_scale(self._scaled_F(dtype), self._n_iter())
        ).astype(dtype)
        scale = ell_pow * db
        return scale[None, :] / scale[:, None]

    def transitions_m1_tl(self, dts: Array):
        """Time-last ``expm(dt·F) − I`` via the trace-time spectral form
        (see _rbf_spectral): elementwise exp/cos/sin in u = dt/ℓ on (T,)
        planes — replaces the Padé expm1 path for order ≤ 8 at ~d²
        elementwise ops per step instead of the 13th-order Padé solve."""
        if self.order > _SPECTRAL_MAX_ORDER:
            return None
        dtype = dts.dtype
        dim = self.order
        blocks = _rbf_spectral(self.order)
        kap = self._kappa(dtype)
        u = dts.reshape(-1) / jnp.asarray(self.lengthscales, dtype)
        out = jnp.zeros((dim, dim, u.shape[0]), dtype)
        for alpha, beta, G, S in blocks:
            au = (-alpha) * u  # α < 0 (stable roots) → au ≥ 0
            if S is None:
                em1 = jnp.expm1(-au)
                out = out + em1[None, None, :] * (
                    kap * jnp.asarray(G, dtype)
                )[:, :, None]
            else:
                bu = beta * u
                cb = jnp.cos(bu)
                em1c = jnp.expm1(-au) * cb - 2.0 * jnp.sin(0.5 * bu) ** 2
                es = jnp.exp(-au) * jnp.sin(bu)
                out = (
                    out
                    + em1c[None, None, :]
                    * (kap * jnp.asarray(G, dtype))[:, :, None]
                    + es[None, None, :]
                    * (kap * jnp.asarray(S, dtype))[:, :, None]
                )
        return out

    def transitions_m1(self, dts: Array):
        m1 = self.transitions_m1_tl(dts)
        if m1 is None:
            return None
        return jnp.moveaxis(m1, -1, 0)

    def transition_coeffs(self):
        """Closed form (see SDEKernel.transition_coeffs): the spectral
        closed form with the κ similarity folded into per-block projector
        coefficient matrices.  Coefficient layout:
        [1/ℓ | per block: κ·G (d²) and, for conjugate pairs, κ·S (d²)];
        the eigenvalue block structure (α_k, β_k) is static Python data
        from the parameter-independent F(1)."""
        if self.order > _SPECTRAL_MAX_ORDER:
            return None
        dtype = config.default_float()
        dim = self.order
        blocks = _rbf_spectral(self.order)
        kap = self._kappa(dtype)
        inv_ell = 1.0 / jnp.asarray(self.lengthscales, dtype)
        parts = [inv_ell.reshape(1)]
        meta = []  # (alpha, beta, offG, offS)
        off = 1
        for alpha, beta, G, S in blocks:
            parts.append((kap * jnp.asarray(G, dtype)).reshape(-1))
            offG = off
            off += dim * dim
            offS = None
            if S is not None:
                parts.append((kap * jnp.asarray(S, dtype)).reshape(-1))
                offS = off
                off += dim * dim
            meta.append((float(alpha), float(beta), offG, offS))
        coeffs = jnp.concatenate(parts)
        meta = tuple(meta)

        def build(c, dt):
            u = dt * c[0]
            rows = [[None] * dim for _ in range(dim)]
            for alpha, beta, offG, offS in meta:
                au = (-alpha) * u
                if offS is None:
                    em1 = jnp.expm1(-au)
                    es = None
                else:
                    bu = beta * u
                    cb = jnp.cos(bu)
                    em1 = jnp.expm1(-au) * cb - 2.0 * jnp.sin(0.5 * bu) ** 2
                    es = jnp.exp(-au) * jnp.sin(bu)
                for i in range(dim):
                    for j in range(dim):
                        t = em1 * c[offG + i * dim + j]
                        if es is not None:
                            t = t + es * c[offS + i * dim + j]
                        rows[i][j] = (
                            t if rows[i][j] is None else rows[i][j] + t
                        )
            return rows

        return coeffs, build

    def dense(self, X: Array, X2: Array) -> Array:
        r = scaled_dist(X, X2, self.lengthscales)
        return self.variance * jnp.exp(-0.5 * r**2)
