"""Core container types.

Both containers are NamedTuples, hence automatically JAX pytrees: they pass
transparently through ``jit`` / ``grad`` / ``vmap`` / ``shard_map``.

Reference equivalents:
  - ``LGSSM``: pssgp/kalman/base.py:3
  - ``ContinuousDiscreteModel``: pssgp/kernels/base.py:15
"""
from __future__ import annotations

from typing import NamedTuple

import jax

Array = jax.Array


class LGSSM(NamedTuple):
    """Discrete linear-Gaussian state-space model over T time steps.

    The initial mean is implicitly zero (reference: pssgp/kalman/sequential.py:14).

    Observation dimensionality: every reference experiment observes a SCALAR
    per step (H is a single row — pssgp/kernels/base.py, all kernels emit
    ``H (1, d)``), and the fast path (the time-last engine) is specialized
    to that case.  The sequential and generic
    parallel engines accept general ``H (m, d)`` / ``R (m, m)`` /
    ``ys (T, m)`` with (m, m) solves, exactly as the reference algebra is
    written (pssgp/kalman/parallel.py:26-33); pass ``engine='generic'`` for
    m > 1.  A step with ANY NaN component is treated as fully missing.

    Attributes:
      P0: (d, d) initial state covariance (stationary covariance of the SDE).
      Fs: (T, d, d) per-step transition matrices ``expm(dt_k * F)``.
      Qs: (T, d, d) per-step process-noise covariances.
      H:  (m, d) shared observation matrix (m = 1 in all reference protocols).
      R:  (m, m) observation-noise covariance.
    """

    P0: Array
    Fs: Array
    Qs: Array
    H: Array
    R: Array


class LGSSMTL(NamedTuple):
    """Time-last (structure-of-arrays) LGSSM — the fast-path layout.

    Identical semantics to :class:`LGSSM` but with the time axis LAST, so
    every (i, j) entry is one contiguous (T,) plane and no (T, d, d) ↔
    (d, d, T) relayouts are needed anywhere in the parallel engines (a
    single such transpose costs more than the entire scan at T = 10⁶).

    Attributes:
      P0: (d, d) initial state covariance.
      Fs: (d, d, T) per-step transition matrices.
      Qs: (d, d, T) per-step process-noise covariances.
      H:  (1, d) shared observation row.
      R:  (1, 1) observation-noise covariance.
    """

    P0: Array
    Fs: Array
    Qs: Array
    H: Array
    R: Array


class ContinuousDiscreteModel(NamedTuple):
    """LTI SDE ``dx = F x dt + L dW`` with spectral density Q and readout H.

    Attributes:
      P0: (d, d) stationary covariance, solving ``F P + P Fᵀ + L Q Lᵀ = 0``.
      F:  (d, d) drift matrix.
      L:  (d, m) diffusion selection matrix.
      H:  (1, d) observation row.
      Q:  (m, m) white-noise spectral density.
    """

    P0: Array
    F: Array
    L: Array
    H: Array
    Q: Array
