"""Hyperparameter MCMC and time-axis scale-out in one tour.

1. HMC over a StateSpaceGP's hyperparameters (unconstrained space, Normal
   priors) — the reference's pssgp/experiments workflow, fully jitted.
2. Four vmapped chains in parallel (``sample_chains``).
3. The same model's likelihood evaluated with the time axis sharded over a
   virtual 8-device mesh — the multi-device path (set
   XLA_FLAGS=--xla_force_host_platform_device_count=8 before running to
   simulate eight devices on CPU).

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/mcmc_and_scale.py
"""
from __future__ import annotations

import os
import sys

# Runnable straight from a checkout: python examples/<name>.py
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import parallel_gps_tpu as pgt
    from parallel_gps_tpu.inference import hmc_kernel, sample_chains

    from parallel_gps_tpu.inference.optim import make_log_posterior
    from parallel_gps_tpu.models.params import unconstrain
    from parallel_gps_tpu.toymodels import obs_noise, sinu

    rng = np.random.RandomState(0)
    t = np.sort(rng.rand(400))
    y = obs_noise(sinu(t), 0.1, 42)
    model = pgt.StateSpaceGP.create(
        (t, y), pgt.kernels.Matern32(1.0, 0.5), 0.1, parallel=True
    )

    # --- HMC over unconstrained hyperparameters with N(0,3²) priors -------
    priors = {
        "kernel.variance": lambda u: -0.5 * (u / 3.0) ** 2,
        "kernel.lengthscales": lambda u: -0.5 * (u / 3.0) ** 2,
        "noise_variance": lambda u: -0.5 * ((u - 0.1) / 1.0) ** 2,
    }
    log_post, u0 = make_log_posterior(model, priors)

    from jax.flatten_util import ravel_pytree

    flat0, unravel = ravel_pytree(u0)
    kernel = hmc_kernel(
        lambda x: log_post(unravel(x)), step_size=0.02, num_leapfrog_steps=10
    )

    # --- 4 chains, vmapped, jittered starts --------------------------------
    n_chains = 4
    inits = {"x": flat0[None] + 0.1 * rng.randn(n_chains, flat0.shape[0])}
    samples, accepted = sample_chains(
        kernel,
        inits,
        lambda tree: log_post(unravel(tree["x"])),
        jax.random.PRNGKey(0),
        num_samples=300,
        num_burnin=100,
    )
    xs = np.asarray(samples["x"])  # (chains, samples, n_params)
    print(
        f"{n_chains} chains x 300 samples, accept="
        f"{float(np.mean(np.asarray(accepted))):.2f}"
    )
    from parallel_gps_tpu.models.params import softplus

    post_ls = np.asarray(softplus(jnp.asarray(xs[..., 1]))).ravel()
    print(
        f"posterior lengthscale: {post_ls.mean():.3f} ± {post_ls.std():.3f}"
    )

    # --- sharded likelihood over a time mesh -------------------------------
    n_dev = len(jax.devices())
    if n_dev > 1:
        from parallel_gps_tpu.parallel.sharded import (
            make_time_mesh,
            sharded_pkf_tl,
        )

        T = 64 * n_dev
        ts2 = np.linspace(0.0, 4.0, T)
        ys2 = jnp.asarray(obs_noise(sinu(ts2), 0.1, 7)).reshape(-1, 1)
        ssm = pgt.kernels.Matern32(1.0, 0.5).get_ssm_tl(
            jnp.asarray(ts2).reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1)
        )
        mesh = make_time_mesh()
        _, _, ell = jax.jit(
            lambda s, o: sharded_pkf_tl(s, o, mesh, return_loglikelihood=True)
        )(ssm, ys2)
        print(f"sharded LML over {n_dev} devices: {float(ell):.3f}")
    else:
        print("single device — set XLA_FLAGS for the sharded demo")


if __name__ == "__main__":
    main()
