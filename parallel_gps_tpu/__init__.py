"""parallel-gps-tpu: state-space Gaussian-process inference on accelerators.

A from-scratch JAX/XLA framework with the capability set of
EEA-sensors/parallel-gps (arXiv 2102.09964): stationary-kernel GP regression
compiled to linear-Gaussian state-space form and solved by Kalman
filtering/smoothing — sequentially (O(T) span) or via associative scan
(O(log T) span) — with the time axis shardable across a device mesh.
"""
from parallel_gps_tpu import config, kalman, kernels, models, ops
from parallel_gps_tpu.models import GPR, StateSpaceGP
from parallel_gps_tpu.types import LGSSM, LGSSMTL, ContinuousDiscreteModel

__version__ = "0.1.0"

__all__ = [
    "config",
    "kalman",
    "kernels",
    "models",
    "ops",
    "GPR",
    "StateSpaceGP",
    "LGSSM",
    "LGSSMTL",
    "ContinuousDiscreteModel",
]
