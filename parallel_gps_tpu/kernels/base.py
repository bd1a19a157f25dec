"""Kernel → SDE compiler: base classes and Sum/Product combinators.

Kernels are immutable pytree dataclasses (``parallel_gps_tpu.pytree``) whose
leaves are the (constrained) hyperparameters — they pass directly through
``jit`` / ``grad`` / ``vmap``.  Each kernel provides:

  - ``get_sde()``: the LTI SDE of the stationary covariance
    (reference: pssgp/kernels/base.py:62-71),
  - ``get_ssm(ts, R, t0)``: discretized LGSSM over given time stamps
    (reference: pssgp/kernels/base.py:73-93),
  - ``dense(X, X2)``: the dense covariance matrix — used by the dense-GP
    oracle that anchors all parity tests,
  - ``state_dim``: static state dimension.

``+`` and ``*`` build Sum/Product kernels (reference: pssgp/kernels/base.py:95-99).
"""
from __future__ import annotations

from functools import reduce
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu import config, pytree
from parallel_gps_tpu.ops.balance import balance_scale, balance_ss
from parallel_gps_tpu.ops.disc import discretize, discretize_tl
from parallel_gps_tpu.ops.expm import expm1_dt_batched
from parallel_gps_tpu.ops.linalg import mm
from parallel_gps_tpu.ops.lyapunov import solve_lyap_vec
from parallel_gps_tpu.types import LGSSM, LGSSMTL, ContinuousDiscreteModel


class SDEKernel:
    """Mixin with shared behavior; concrete kernels are struct dataclasses."""

    def get_sde(self) -> ContinuousDiscreteModel:
        raise NotImplementedError

    def dense(self, X: Array, X2: Array) -> Array:
        raise NotImplementedError

    @property
    def state_dim(self) -> int:
        raise NotImplementedError

    def transitions_m1(self, dts: Array):
        """Closed-form ``expm(dt_k · F) − I`` of this kernel's (balanced)
        SDE, or None to use the generic batched Padé-13 expm1 path.

        Kernels with analytic matrix exponentials (Matérn: nilpotent shift
        of a multiple eigenvalue; Periodic: plane rotations) override this.
        The minus-identity form is what discretization actually consumes
        (see ops/disc.py): it keeps ``Q = P − A P Aᵀ`` cancellation-free in
        float32 at tiny dt, and costs O(T d²) elementwise work."""
        return None

    def transitions(self, dts: Array):
        """``expm(dt_k · F)``, derived from :meth:`transitions_m1`; None when
        the kernel has no closed form."""
        m1 = self.transitions_m1(dts)
        if m1 is None:
            return None
        return m1 + jnp.eye(m1.shape[-1], dtype=m1.dtype)

    def get_ssm(self, ts: Array, R: Array, t0=0.0) -> LGSSM:
        sde = self.get_sde()
        dtype = sde.F.dtype

        def trans_m1(dts):
            Am1 = self.transitions_m1(dts.astype(dtype))
            if Am1 is None:
                Am1 = expm1_dt_batched(sde.F, dts.astype(dtype))
            return Am1

        return discretize(sde, ts, R, t0, transitions_m1=trans_m1)

    def transitions_m1_tl(self, dts: Array):
        """Time-last ``expm(dt_k · F) − I`` as (d, d, T), or None.

        Kernels with closed forms build this from (T,) planes by pure
        broadcasts (no relayout); the default derives it from
        :meth:`transitions_m1` via one transpose."""
        m1 = self.transitions_m1(dts)
        if m1 is None:
            return None
        return jnp.moveaxis(m1, 0, -1)

    def get_ssm_tl(self, ts: Array, R: Array, t0=0.0) -> LGSSMTL:
        """Time-last LGSSM — the fast-path layout (see types.LGSSMTL)."""
        sde = self.get_sde()
        dtype = sde.F.dtype

        def trans_m1_tl(dts):
            Am1 = self.transitions_m1_tl(dts.astype(dtype))
            if Am1 is None:
                # Time-last Padé path: expm1_dt_tl stays on (d, d, T)
                # planes end-to-end, with no (T, d, d) relayout
                # (ops/expm.py).
                from parallel_gps_tpu.ops.expm import expm1_dt_tl

                Am1 = expm1_dt_tl(sde.F, dts.astype(dtype))
            return Am1

        return discretize_tl(sde, ts, R, t0, transitions_m1_tl=trans_m1_tl)

    def transition_coeffs(self):
        """Elementwise closed form of the transitions: ``(coeffs, build)``
        or None.

        ``coeffs`` is a flat (n,) coefficient vector — an arbitrary traced
        function of the kernel's hyperparameters (it may balance, take
        roots, etc.).  ``build`` is a STATIC Python callable (it must not
        close over traced values) mapping ``(c, dt) -> Am1`` where ``c`` is
        the list of n scalar coefficients, ``dt`` an array of any shape, and
        ``Am1 = expm(dt·F) − I`` is returned as a d×d list-of-lists of
        arrays shaped like ``dt`` using ONLY elementwise ops
        (exp/expm1/sin/mul/add).  An entry may be ``None``, meaning exactly
        zero (see :func:`zmul` / :func:`zsum`), so Sum block-diagonals and
        Periodic rotation planes carry their structural zeros.

        This is the contract a fused scan kernel needs to rebuild F and the
        cancellation-free ``Q = P∞ − A P∞ Aᵀ`` from the (T,) dt plane
        instead of reading (d, d, T) planes; it must agree entrywise with
        :meth:`transitions_m1_tl`.  Kernels without an elementwise closed
        form return None (default)."""
        return None

    def __add__(self, other: "SDEKernel") -> "Sum":
        return Sum(kernels=(self, other))

    def __mul__(self, other: "SDEKernel") -> "Product":
        return Product(kernels=(self, other))


def zmul(a, b):
    """None-as-structural-zero product (see SDEKernel.transition_coeffs)."""
    return None if a is None or b is None else a * b


def zsum(terms):
    """None-aware sum; None when every term is structurally zero."""
    live = [t for t in terms if t is not None]
    if not live:
        return None
    out = live[0]
    for t in live[1:]:
        out = out + t
    return out


def _block_diag(arrs) -> Array:
    """Block-diagonal stack of possibly non-square matrices
    (reference: pssgp/kernels/base.py:113-127)."""
    rows = sum(a.shape[0] for a in arrs)
    cols = sum(a.shape[1] for a in arrs)
    out = jnp.zeros((rows, cols), dtype=arrs[0].dtype)
    r = c = 0
    for a in arrs:
        out = out.at[r : r + a.shape[0], c : c + a.shape[1]].set(a)
        r += a.shape[0]
        c += a.shape[1]
    return out


@pytree.dataclass
class Sum(SDEKernel):
    """Sum of SDE kernels: concatenated (block-diagonal) state space
    (reference: pssgp/kernels/base.py:130-183)."""

    kernels: Tuple[SDEKernel, ...]
    balancing_iter: int = pytree.field(pytree_node=False, default=-1)

    @property
    def state_dim(self) -> int:
        return sum(k.state_dim for k in self.kernels)

    def get_sde(self) -> ContinuousDiscreteModel:
        sdes = [k.get_sde() for k in self.kernels]
        F = _block_diag([s.F for s in sdes])
        L = _block_diag([s.L for s in sdes])
        H = jnp.concatenate([s.H for s in sdes], axis=1)
        Q = _block_diag([s.Q for s in sdes])
        n_iter = (
            self.balancing_iter
            if self.balancing_iter >= 0
            else config.NUMBER_OF_BALANCING_STEPS
        )
        Fb, Lb, Hb, Qb = balance_ss(F, L, H, Q, n_iter)
        Pinf = solve_lyap_vec(Fb, Lb, Qb)
        return ContinuousDiscreteModel(Pinf, Fb, Lb, Hb, Qb)

    def dense(self, X: Array, X2: Array) -> Array:
        return reduce(jnp.add, [k.dense(X, X2) for k in self.kernels])

    def _n_iter(self) -> int:
        return (
            self.balancing_iter
            if self.balancing_iter >= 0
            else config.NUMBER_OF_BALANCING_STEPS
        )

    def transitions_m1(self, dts: Array):
        """Block-diagonal stack of the children's ``A − I`` operators,
        conjugated by this Sum's balancing similarity (a block-diagonal F
        exponentiates blockwise; subtracting I commutes with both the
        block-diagonal stacking and the diagonal similarity)."""
        sdes = [k.get_sde() for k in self.kernels]
        children = []
        for k, s in zip(self.kernels, sdes):
            m1 = k.transitions_m1(dts)
            if m1 is None:
                m1 = expm1_dt_batched(s.F, dts)
            children.append(m1)
        T = dts.shape[0]
        dim = sum(s.F.shape[0] for s in sdes)
        out = jnp.zeros((T, dim, dim), children[0].dtype)
        r = 0
        for m1 in children:
            dk = m1.shape[-1]
            out = out.at[:, r : r + dk, r : r + dk].set(m1)
            r += dk
        F = _block_diag([s.F for s in sdes])
        d = jax.lax.stop_gradient(balance_scale(F, self._n_iter()))
        return out * (d[None, None, :] / d[None, :, None])

    def transitions_m1_tl(self, dts: Array):
        """Time-last counterpart of :meth:`transitions_m1`: children's
        (dk, dk, T) planes written into the block diagonal of a (d, d, T)
        stack — no batched (T, d, d) layout is ever materialized."""
        from parallel_gps_tpu.ops.expm import expm1_dt_tl

        sdes = [k.get_sde() for k in self.kernels]
        children = []
        for k, s in zip(self.kernels, sdes):
            m1 = k.transitions_m1_tl(dts)
            if m1 is None:
                m1 = expm1_dt_tl(s.F, dts)
            children.append(m1)
        T = dts.shape[0]
        dim = sum(s.F.shape[0] for s in sdes)
        out = jnp.zeros((dim, dim, T), children[0].dtype)
        r = 0
        for m1 in children:
            dk = m1.shape[0]
            out = out.at[r : r + dk, r : r + dk, :].set(m1)
            r += dk
        F = _block_diag([s.F for s in sdes])
        d = jax.lax.stop_gradient(balance_scale(F, self._n_iter()))
        return out * (d[None, :, None] / d[:, None, None])

    def transition_coeffs(self):
        """Closed form for sums: the children's builds written into the
        block diagonal (structural zeros stay ``None`` — see
        :func:`zmul`), conjugated by this Sum's balancing
        similarity, whose scale vector (and its reciprocal) travels in the
        coefficient vector.  None when any child lacks a closed form."""
        parts = [k.transition_coeffs() for k in self.kernels]
        if any(p is None for p in parts):
            return None
        sdes = [k.get_sde() for k in self.kernels]
        dims = [int(s.F.shape[0]) for s in sdes]
        F = _block_diag([s.F for s in sdes])
        dvec = jax.lax.stop_gradient(
            balance_scale(F, self._n_iter())
        ).astype(F.dtype)
        coeffs = jnp.concatenate(
            [dvec, 1.0 / dvec] + [p[0].astype(F.dtype) for p in parts]
        )
        builds = tuple(p[1] for p in parts)
        ncs = tuple(int(p[0].shape[0]) for p in parts)
        d = sum(dims)

        def build(c, dt):
            rows = [[None] * d for _ in range(d)]
            off = 2 * d
            r0 = 0
            for bk, nc, dk in zip(builds, ncs, dims):
                sub = bk(c[off : off + nc], dt)
                for i in range(dk):
                    for j in range(dk):
                        e = sub[i][j]
                        if e is not None and i != j:
                            # similarity scale d_j / d_i (diag scale is 1)
                            e = e * (c[r0 + j] * c[d + r0 + i])
                        rows[r0 + i][r0 + j] = e
                off += nc
                r0 += dk
            return rows

        return coeffs, build

    def __repr__(self):  # compact form of the nested dataclass repr
        return f"Sum({', '.join(map(repr, self.kernels))})"


def _kron_F(F1: Array, F2: Array) -> Array:
    """F = F1 ⊗ I + I ⊗ F2 (reference: pssgp/kernels/base.py:199-207)."""
    I1 = jnp.eye(F1.shape[0], dtype=F1.dtype)
    I2 = jnp.eye(F2.shape[0], dtype=F2.dtype)
    return jnp.kron(F1, I2) + jnp.kron(I1, F2)


@pytree.dataclass
class Product(SDEKernel):
    """Product of SDE kernels via Kronecker algebra
    (reference: pssgp/kernels/base.py:186-244).

    Unlike the reference (whose reduce over >2 kernels is ill-typed), the
    pairwise fold here carries a well-formed intermediate SDE, so products of
    any arity work.
    """

    kernels: Tuple[SDEKernel, ...]
    balancing_iter: int = pytree.field(pytree_node=False, default=-1)

    @property
    def state_dim(self) -> int:
        out = 1
        for k in self.kernels:
            out *= k.state_dim
        return out

    def get_sde(self) -> ContinuousDiscreteModel:
        sdes = [k.get_sde() for k in self.kernels]

        def fold(s1: ContinuousDiscreteModel, s2: ContinuousDiscreteModel):
            F = _kron_F(s1.F, s2.F)
            gamma1 = mm(mm(s1.L, s1.Q), s1.L.T)
            gamma2 = mm(mm(s2.L, s2.Q), s2.L.T)
            Q = jnp.kron(gamma1, s2.P0) + jnp.kron(s1.P0, gamma2)
            H = jnp.kron(s1.H, s2.H)
            P0 = jnp.kron(s1.P0, s2.P0)
            L = jnp.eye(F.shape[0], dtype=F.dtype)
            return ContinuousDiscreteModel(P0, F, L, H, Q)

        s = reduce(fold, sdes)
        n_iter = (
            self.balancing_iter
            if self.balancing_iter >= 0
            else config.NUMBER_OF_BALANCING_STEPS
        )
        Fb, Lb, Hb, Qb = balance_ss(s.F, s.L, s.H, s.Q, n_iter)
        Pinf = solve_lyap_vec(Fb, Lb, Qb)
        return ContinuousDiscreteModel(Pinf, Fb, Lb, Hb, Qb)

    def dense(self, X: Array, X2: Array) -> Array:
        return reduce(jnp.multiply, [k.dense(X, X2) for k in self.kernels])

    def transitions_m1(self, dts: Array):
        """Kronecker form: F = F1 ⊗ I + I ⊗ F2 has commuting terms, so
        A = A1 ⊗ A2; in minus-identity form (cancellation-free),
        A − I = Am1_1 ⊗ Am1_2 + Am1_1 ⊗ I + I ⊗ Am1_2.  Conjugated by this
        Product's balancing similarity."""
        sdes = [k.get_sde() for k in self.kernels]
        children = []
        for k, s in zip(self.kernels, sdes):
            m1 = k.transitions_m1(dts)
            if m1 is None:
                m1 = expm1_dt_batched(s.F, dts)
            children.append(m1)

        def bkron(a, b):  # batched Kronecker over the leading T axis
            T, da, _ = a.shape
            db = b.shape[-1]
            return (
                a[:, :, None, :, None] * b[:, None, :, None, :]
            ).reshape(T, da * db, da * db)

        def fold_m1(am1, bm1):
            T = am1.shape[0]
            Ia = jnp.broadcast_to(
                jnp.eye(am1.shape[-1], dtype=am1.dtype), am1.shape
            )
            Ib = jnp.broadcast_to(
                jnp.eye(bm1.shape[-1], dtype=bm1.dtype), bm1.shape
            )
            return bkron(am1, bm1) + bkron(am1, Ib) + bkron(Ia, bm1)

        out = reduce(fold_m1, children)
        F = reduce(lambda F1, F2: _kron_F(F1, F2), [s.F for s in sdes])
        d = jax.lax.stop_gradient(balance_scale(F, self._n_iter()))
        return out * (d[None, None, :] / d[None, :, None])

    def transitions_m1_tl(self, dts: Array):
        """Time-last Kronecker fold (see :meth:`transitions_m1`): the
        Kronecker products broadcast over (dₐ, d_b, dₐ, d_b, T) with the T
        axis last, so no batched (T, d, d) layout appears — the
        quasi-periodic CO2 composite (d = 18) discretizes at N ≥ 1M in
        (d, d, T) planes."""
        from parallel_gps_tpu.ops.expm import expm1_dt_tl

        sdes = [k.get_sde() for k in self.kernels]
        children = []
        for k, s in zip(self.kernels, sdes):
            m1 = k.transitions_m1_tl(dts)
            if m1 is None:
                m1 = expm1_dt_tl(s.F, dts)
            children.append(m1)

        def bkron_tl(a, b):  # Kronecker over the leading dims, T last
            da = a.shape[0]
            db = b.shape[0]
            T = a.shape[-1]
            return (
                a[:, None, :, None, :] * b[None, :, None, :, :]
            ).reshape(da * db, da * db, T)

        def fold_m1_tl(am1, bm1):
            Ia = jnp.broadcast_to(
                jnp.eye(am1.shape[0], dtype=am1.dtype)[:, :, None], am1.shape
            )
            Ib = jnp.broadcast_to(
                jnp.eye(bm1.shape[0], dtype=bm1.dtype)[:, :, None], bm1.shape
            )
            return bkron_tl(am1, bm1) + bkron_tl(am1, Ib) + bkron_tl(Ia, bm1)

        out = reduce(fold_m1_tl, children)
        F = reduce(lambda F1, F2: _kron_F(F1, F2), [s.F for s in sdes])
        d = jax.lax.stop_gradient(balance_scale(F, self._n_iter()))
        return out * (d[None, :, None] / d[:, None, None])

    def _n_iter(self) -> int:
        return (
            self.balancing_iter
            if self.balancing_iter >= 0
            else config.NUMBER_OF_BALANCING_STEPS
        )

    def transition_coeffs(self):
        """Closed form for products: the commuting-Kronecker fold
        ``A − I = Am1_a ⊗ Am1_b + Am1_a ⊗ I + I ⊗ Am1_b`` applied entrywise
        to the children's builds (None = structural zero propagates through
        the fold), conjugated by this Product's balancing similarity.  None
        when any child lacks a closed form."""
        parts = [k.transition_coeffs() for k in self.kernels]
        if any(p is None for p in parts):
            return None
        sdes = [k.get_sde() for k in self.kernels]
        dims = [int(s.F.shape[0]) for s in sdes]
        F = reduce(lambda F1, F2: _kron_F(F1, F2), [s.F for s in sdes])
        dvec = jax.lax.stop_gradient(
            balance_scale(F, self._n_iter())
        ).astype(F.dtype)
        d = int(F.shape[0])
        coeffs = jnp.concatenate(
            [dvec, 1.0 / dvec] + [p[0].astype(F.dtype) for p in parts]
        )
        builds = tuple(p[1] for p in parts)
        ncs = tuple(int(p[0].shape[0]) for p in parts)

        def build(c, dt):
            off = 2 * d
            mats = []
            for bk, nc in zip(builds, ncs):
                mats.append(bk(c[off : off + nc], dt))
                off += nc

            def fold(A, B):
                da, db = len(A), len(B)
                out = [[None] * (da * db) for _ in range(da * db)]
                for i1 in range(da):
                    for j1 in range(da):
                        for i2 in range(db):
                            for j2 in range(db):
                                out[i1 * db + i2][j1 * db + j2] = zsum(
                                    [
                                        zmul(A[i1][j1], B[i2][j2]),
                                        A[i1][j1] if i2 == j2 else None,
                                        B[i2][j2] if i1 == j1 else None,
                                    ]
                                )
                return out

            rows = reduce(fold, mats)
            for i in range(d):
                for j in range(d):
                    if i != j and rows[i][j] is not None:
                        rows[i][j] = rows[i][j] * (c[j] * c[d + i])
            return rows

        return coeffs, build

    def __repr__(self):
        return f"Product({', '.join(map(repr, self.kernels))})"


def scaled_dist(X: Array, X2: Array, lengthscales) -> Array:
    """|x - x'| / ℓ pairwise matrix for 1-D inputs shaped (N, 1) or (N,)."""
    x = X.reshape(-1, 1)
    x2 = X2.reshape(-1, 1)
    return jnp.abs(x - x2.T) / lengthscales
