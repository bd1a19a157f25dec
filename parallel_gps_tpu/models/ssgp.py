"""State-space GP regression model — the user-facing API.

Functional equivalent of the reference's ``StateSpaceGP``
(pssgp/model.py:58-117): the model is an immutable pytree (data + kernel +
noise), so whole-model ``jit`` / ``grad`` / ``vmap`` come for free — this
replaces the reference's ``tf.function`` signature machinery
(model.py:71-84).  Engine selection (sequential vs parallel) is a static
field; ``max_parallel`` is unnecessary (see kalman/parallel.py) but accepted.

Prediction merges the (sorted) training and query times with a
searchsorted+scatter merge — O(log T) depth rather than a full argsort —
mirroring reference model.py:15-55, injects NaN observations at query points,
runs the smoother over the union, and reads off H-projections.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from parallel_gps_tpu import pytree
from parallel_gps_tpu.kalman.parallel import pkfs
from parallel_gps_tpu.kalman.sequential import kf, kfs
from parallel_gps_tpu.kernels.base import SDEKernel
from parallel_gps_tpu.ops.linalg import mm
from parallel_gps_tpu.types import LGSSM, LGSSMTL


def merge_sorted(a: Array, b: Array, a_data, b_data):
    """Stable merge of two sorted 1-D arrays plus parallel payloads.

    Returns (merged_keys, merged_payloads, b_positions_mask) where the mask is
    True at positions coming from ``b``.  Equivalent to the reference's
    ``_merge_sorted`` (pssgp/model.py:15-55) — searchsorted + two scatters
    instead of argsort.
    """
    na, nb = a.shape[0], b.shape[0]
    n = na + nb
    # Position of each b-element in the merged array: its searchsorted index
    # into a (a-elements before it) plus the number of b-elements before it.
    b_pos = jnp.searchsorted(a, b) + jnp.arange(nb)
    is_b = jnp.zeros((n,), bool).at[b_pos].set(True)
    a_pos = jnp.nonzero(jnp.logical_not(is_b), size=na)[0]

    def scatter(u, v):
        out = jnp.zeros((n,) + u.shape[1:], dtype=u.dtype)
        out = out.at[a_pos].set(u)
        out = out.at[b_pos].set(v)
        return out

    merged = scatter(a, b)
    payloads = tuple(scatter(u, v) for u, v in zip(a_data, b_data))
    return merged, payloads, is_b


@pytree.dataclass
class StateSpaceGP:
    ts: Array  # (T, 1) sorted time stamps
    ys: Array  # (T, 1) observations, NaN = missing
    kernel: SDEKernel
    noise_variance: Array
    parallel: bool = pytree.field(pytree_node=False, default=True)
    # Optional device mesh with a "time" axis: LML and predict_f route
    # through the time-axis-sharded two-level engines (parallel/sharded.py)
    # — the multi-device path, reachable from the model API like everything
    # else (the reference's entire user surface is the model object,
    # pssgp/model.py:58-117).  Static (part of the pytree treedef): one
    # compile per mesh, reused across hyperparameter values.
    mesh: object = pytree.field(pytree_node=False, default=None)
    # Square-root (Cholesky-factor) engine: covariances carried as
    # triangular factors, PSD by construction at any conditioning — an f32
    # alternative to the reference's float64 stability axis (its d ≥ 12
    # sweeps run f64-only).  At d=12 in f32 the standard engines lose
    # definiteness at large T while this engine stays PSD; it costs ~2-3×
    # the flops (QR triangularizations).  Use it for d ≳ 8 f32
    # COMPANION-FORM kernels (Matérn/RBF; rank-1 dispersion → quadrature
    # noise factors) at large T.  For Sum/Product composites the factor
    # fallback is eigh of the assembled planes, which is LESS accurate
    # than the standard engines wherever those are still finite — prefer
    # stable=False there, or float64, which the GPU runs natively.
    stable: bool = pytree.field(pytree_node=False, default=False)

    @classmethod
    def create(
        cls,
        data,
        kernel: SDEKernel,
        noise_variance: float = 1.0,
        parallel: bool = True,
        max_parallel: int = 0,  # reference-API compat; unused
        dtype=None,
        mesh=None,
        stable: bool = False,
    ) -> "StateSpaceGP":
        """``mesh``: a ``jax.sharding.Mesh`` with a ``"time"`` axis to shard
        the time dimension of the scans across devices/hosts (requires
        ``parallel=True``); None (default) runs single-device.  Training
        (``inference.fit_adam`` / ``fit_lbfgs``) and MCMC consume the model's
        LML, so they run distributed automatically — gradients flow through
        the sharded Fisher-identity VJP (parallel/sharded.py::sharded_lml_tl).
        """
        del max_parallel
        ts, ys = data
        if dtype is None:
            from parallel_gps_tpu.config import default_float

            dtype = default_float()
        if mesh is not None:
            if not parallel:
                raise ValueError("mesh requires parallel=True")
            if "time" not in mesh.shape:
                raise ValueError(
                    f"mesh must have a 'time' axis, got {tuple(mesh.shape)}"
                )
        if stable:
            if not parallel:
                raise ValueError("stable=True requires parallel=True")
            if mesh is not None:
                raise ValueError(
                    "stable=True is single-device (the sqrt engine has no "
                    "sharded variant); drop mesh or stable"
                )
        ts = jnp.asarray(ts, dtype).reshape(-1, 1)
        ys = jnp.asarray(ys, dtype).reshape(-1, 1)
        return cls(
            ts=ts,
            ys=ys,
            kernel=kernel,
            noise_variance=jnp.asarray(noise_variance, dtype),
            parallel=parallel,
            mesh=mesh,
            stable=stable,
        )

    def _on_mesh(self, time_axis, *xs: Array):
        """Constrain (T, 1) arrays to the mesh: time axis over
        ``time_axis`` (a mesh axis name, or None for replicated)."""
        from jax.sharding import NamedSharding, PartitionSpec

        sharding = NamedSharding(self.mesh, PartitionSpec(time_axis, None))
        return tuple(jax.lax.with_sharding_constraint(x, sharding) for x in xs)

    def _make_model(self, ts: Array) -> LGSSM:
        R = jnp.reshape(self.noise_variance, (1, 1))
        # Parallel engine: build the SSM time-last (LGSSMTL) so the whole
        # filter/smoother pipeline runs relayout-free — pkf/pkfs dispatch on
        # the container type (kalman/parallel.py).  The time-last engine
        # covers every state dim (Schur-recursed inverses for d > 3,
        # kalman/timelast.py::_inv).
        if self.parallel:
            return self.kernel.get_ssm_tl(ts, R)
        return self.kernel.get_ssm(ts, R)

    def log_marginal_likelihood(self) -> Array:
        """LML of the data (reference: pssgp/model.py:113-117).

        Engine dispatch, the same for ``predict_f``: ``stable`` → the
        square-root engine; ``mesh`` → the time-axis-sharded time-last
        engine; ``parallel`` → the time-last engine; else the sequential
        engine.  On the time-last paths the gradient is the Fisher-identity
        custom VJP (kalman.timelast.lml_tl): one smoother pass instead of
        replaying the scan tree.

        Jitted with the model as a pytree argument, so the compiled program
        is reused across hyperparameter values and model instances — the
        role of the reference's pre-compiled ``tf.function`` signatures
        (pssgp/model.py:71-84).  Under an outer ``jit``/``grad``/``vmap``
        the inner jit is free."""
        return _lml_jit(self)

    def _lml_impl(self) -> Array:
        ts, ys = self.ts, self.ys
        if self.stable:
            # Square-root engine (kalman/sqrt.py): triangular-factor
            # combines + quadrature-Gramian discretization factors.
            # Gradients ride the square-root Fisher-identity VJP
            # (sqrt.sqrt_lml: backward = one sqrt smoother + factor-solve
            # formulas — autodiff through the QR combines would NaN on the
            # rank-m information factors).
            from parallel_gps_tpu.kalman.sqrt import sqrt_lml_kernel

            return sqrt_lml_kernel(
                self.kernel, ts, jnp.reshape(self.noise_variance, (1, 1)),
                ys,
            )
        if self.mesh is not None:
            # Time-axis-sharded path: pad to a multiple of the shard count
            # with exact no-op steps, then the distributed Fisher-VJP LML
            # (forward = sharded filter + one tiny all_gather; backward =
            # one sharded smoother pass).
            from parallel_gps_tpu.parallel.sharded import sharded_lml_tl

            # Time axis over the mesh, so the discretization and element
            # construction before the sharded scans are split too.
            ts, ys = self._on_mesh(
                "time", *_align_pad(ts, ys, self.mesh.shape["time"])
            )
            return sharded_lml_tl(self._make_model(ts), ys, self.mesh, "time")
        ssm = self._make_model(ts)
        if isinstance(ssm, LGSSMTL):
            from parallel_gps_tpu.kalman.timelast import lml_tl

            return lml_tl(ssm, ys)
        _, _, ell = kf(ssm, ys, return_loglikelihood=True)
        return ell

    # Alias matching the reference method name (pssgp/model.py:113).
    maximum_log_likelihood_objective = log_marginal_likelihood

    def training_loss(self) -> Array:
        return -self.log_marginal_likelihood()

    def predict_f(self, Xnew: Array, full_cov: bool = False):
        """Posterior mean/variance of f at new inputs
        (reference: pssgp/model.py:92-111).

        ``full_cov`` is accepted for reference API compatibility and, exactly
        like the reference (pssgp/model.py:92-96), ignored: only marginal
        variances are returned.

        Query batches are padded up to power-of-two buckets before the jitted
        body runs, so repeated prediction at varying numbers of query points
        reuses compiles (one trace per bucket) instead of retracing per exact
        count — the static-shape replacement for the reference's dynamic-T
        smoother signature (pssgp/model.py:73-84).  Padding duplicates the
        last query time with a NaN observation, which leaves the posterior at
        every real point untouched (dt=0 ⇒ F=I, Q=0, no update).  The engine
        is chosen as in :meth:`log_marginal_likelihood`."""
        del full_cov
        Xnew = jnp.asarray(Xnew, self.ts.dtype).reshape(-1, 1)
        m = Xnew.shape[0]
        if m == 0:
            return (
                jnp.zeros((0, 1), self.ts.dtype),
                jnp.zeros((0, 1), self.ts.dtype),
            )
        mb = _bucket_size(m)
        if mb != m:
            pad = jnp.broadcast_to(Xnew[-1:], (mb - m, 1))
            Xnew = jnp.concatenate([Xnew, pad], axis=0)
        mean, var = _predict_f_jit(self, Xnew)
        return mean[:m], var[:m]

    def _predict_f_impl(self, Xnew: Array):
        # Sort queries (and later unsort results): unlike the reference, which
        # silently assumes sorted Xnew, unsorted queries are handled correctly.
        order = _argsort(Xnew[:, 0])
        Xsorted = Xnew[order]
        nan_ys = jnp.full((Xnew.shape[0], self.ys.shape[1]), jnp.nan, self.ys.dtype)
        ts, ys = self.ts, self.ys
        if self.mesh is not None:
            # Merge replicated: the searchsorted + scatters of the merge
            # partition badly over a sharded time axis (16.8 s vs 27 ms at
            # N=1M on 4 virtual CPU devices).
            ts, ys = self._on_mesh(None, ts, ys)
        all_ts, (all_ys,), is_query = merge_sorted(
            ts[:, 0], Xsorted[:, 0], (ys,), (nan_ys,)
        )
        all_ts = all_ts[:, None]
        if self.stable:
            # Square-root smoothing over the merged train+query series: the
            # posterior variance is read off the factor as ‖Nᵀ Hᵀ‖² ≥ 0 —
            # no negative query variances at any conditioning (the d=12
            # f32 standard-engine failure mode).
            from parallel_gps_tpu.kalman.sqrt import sqrt_pkfs_kernel

            H_mat = self.kernel.get_sde().H
            sms, sNs = sqrt_pkfs_kernel(
                self.kernel, all_ts,
                jnp.reshape(self.noise_variance, (1, 1)), all_ys,
            )
            q_idx = jnp.nonzero(is_query, size=Xnew.shape[0])[0]
            sms_q, sNs_q = sms[q_idx], sNs[q_idx]
            mean = mm(H_mat[None], sms_q[..., None])[..., 0]
            HN = mm(H_mat[None], sNs_q)  # (M, 1, d)
            var = jnp.sum(HN * HN, axis=-1)  # (M, 1)
            inv_order = _inverse_permutation(order)
            return mean[inv_order], var[inv_order]
        if self.mesh is not None:
            # Time-axis-sharded smoothing over the merged train+query series
            # (see _lml_impl for the padding semantics).
            from parallel_gps_tpu.parallel.sharded import sharded_pkfs_tl

            all_ts, all_ys = self._on_mesh(
                "time", *_align_pad(all_ts, all_ys, self.mesh.shape["time"])
            )
            ssm = self._make_model(all_ts)
            g_tl, L_tl = sharded_pkfs_tl(ssm, all_ys, self.mesh, "time")
            sms = jnp.moveaxis(g_tl, -1, 0)
            sPs = jnp.moveaxis(L_tl, -1, 0)
        else:
            ssm = self._make_model(all_ts)
            sms, sPs = pkfs(ssm, all_ys) if self.parallel else kfs(ssm, all_ys)
        H_mat = ssm.H
        q_idx = jnp.nonzero(is_query, size=Xnew.shape[0])[0]
        sms_q, sPs_q = sms[q_idx], sPs[q_idx]
        mean = mm(H_mat[None], sms_q[..., None])[..., 0]  # (M, 1)
        var = mm(mm(H_mat[None], sPs_q), H_mat.T)[..., 0]  # (M, 1)
        inv_order = _inverse_permutation(order)
        return mean[inv_order], var[inv_order]


def _argsort(x: Array) -> Array:
    """Stable argsort of a 1-D array, with int32 indices."""
    idx = jnp.arange(x.shape[0], dtype=jnp.int32)
    return jax.lax.sort((x, idx), num_keys=1, is_stable=True)[1]


def _inverse_permutation(p: Array) -> Array:
    """``argsort(p)`` of a permutation, as one scatter.  Sorting a
    permutation under x64 (int64 keys) makes XLA's GPU sort simplifier emit
    an ill-typed scatter (s32 init for an s64 reduction) that the HLO
    verifier rejects; the explicit scatter avoids the sort altogether."""
    return jnp.zeros_like(p).at[p].set(jnp.arange(p.shape[0], dtype=p.dtype))


def _bucket_size(m: int, min_bucket: int = 16) -> int:
    """Round a query count up to the next power-of-two compile bucket."""
    if m <= min_bucket:
        return min_bucket
    return 1 << (m - 1).bit_length()


def _align_pad(ts: Array, ys: Array, align: int):
    """End-pad (ts, ys) so the time axis is a multiple of ``align`` (the
    shard count — the sharded engines require divisibility): repeated last
    time (dt=0 ⇒ exact identity transitions) and NaN observations (masked
    out), so LML and moments at real positions are unchanged."""
    T = ts.shape[0]
    Tp = -(-T // align) * align
    if Tp == T:
        return ts, ys
    ts_p = jnp.concatenate(
        [ts, jnp.broadcast_to(ts[-1:], (Tp - T,) + ts.shape[1:])], axis=0
    )
    ys_p = jnp.concatenate(
        [ys, jnp.full((Tp - T,) + ys.shape[1:], jnp.nan, ys.dtype)], axis=0
    )
    return ts_p, ys_p


# Module-level jitted method bodies: StateSpaceGP is a pytree dataclass, so
# the model itself is a jit argument — one compile per (shapes, static
# fields), then reused across instances and hyperparameter values.
_lml_jit = jax.jit(StateSpaceGP._lml_impl)
_predict_f_jit = jax.jit(StateSpaceGP._predict_f_impl)
