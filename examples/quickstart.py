"""End-to-end primer (reference: notebooks/PSSGP101.ipynb).

Fits the same kernel through the dense-GP oracle, the sequential state-space
engine, and the parallel associative-scan engine, and compares posteriors.

Run:  python examples/quickstart.py  (CPU ok; add --plot for a figure)
"""
from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: python examples/<name>.py
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--n", type=int, default=400)
    args = ap.parse_args()

    import jax

    # float64 on whatever device JAX picks (the GPU runs it natively).
    jax.config.update("jax_enable_x64", True)

    import parallel_gps_tpu as pgt
    from parallel_gps_tpu.inference import fit_adam
    from parallel_gps_tpu.misc_utils import rmse
    from parallel_gps_tpu.toymodels import obs_noise, sinu

    rng = np.random.RandomState(0)
    t = np.sort(rng.rand(args.n))
    f = sinu(t)
    y = obs_noise(f, 0.1, 42)
    q = np.linspace(0.0, 1.0, 300)

    kernel = pgt.kernels.Matern52(variance=1.0, lengthscales=0.5)

    # Dense-GP oracle — O(N³), the ground truth.
    import jax.numpy as jnp

    gpr = pgt.GPR(
        ts=jnp.asarray(t).reshape(-1, 1),
        ys=jnp.asarray(y).reshape(-1, 1),
        kernel=kernel,
        noise_variance=jnp.asarray(0.1),
    )
    print(f"dense GP       LML: {float(gpr.log_marginal_likelihood()):.4f}")

    results = {}
    for name, parallel in [("sequential", False), ("parallel", True)]:
        model = pgt.StateSpaceGP.create((t, y), kernel, 0.1, parallel=parallel)
        print(f"{name:14s} LML: {float(model.log_marginal_likelihood()):.4f}")
        fitted, history = fit_adam(model, n_iters=200, learning_rate=0.03)
        mean, var = fitted.predict_f(q)
        results[name] = (np.asarray(mean)[:, 0], np.asarray(var)[:, 0])
        print(
            f"{name:14s} fitted: loss {float(history[-1]):.4f}, "
            f"noise {float(fitted.noise_variance):.4f}"
        )

    delta = rmse(results["sequential"][0], results["parallel"][0])
    print(f"sequential-vs-parallel posterior-mean RMSE: {delta:.2e}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from parallel_gps_tpu.misc_utils import error_shade

        mean, var = results["parallel"]
        fig, ax = plt.subplots(figsize=(9, 4))
        ax.plot(t, y, "k.", ms=2, alpha=0.4, label="observations")
        ax.plot(q, mean, "C0", label="posterior mean (parallel)")
        error_shade(ax, q, mean, var, label="95% CI")
        ax.legend()
        fig.savefig("quickstart.png", dpi=120, bbox_inches="tight")
        print("saved quickstart.png")


if __name__ == "__main__":
    main()
