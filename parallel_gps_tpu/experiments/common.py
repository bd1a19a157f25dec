"""Shared experiment machinery: model/covariance factories, the MCMC driver,
and results persistence (reference: pssgp/experiments/common.py).

Differences from the reference: the device is whatever JAX was initialized
with (no ``--device`` flag juggling — set JAX_PLATFORMS); dtype is a
``--dtype`` flag mapped to ``jax_enable_x64``; MCMC runs fully jitted with our
own HMC/MALA/NUTS kernels instead of TFP's.
"""
from __future__ import annotations

import argparse
import enum
import time

import numpy as np


def progress(iterable, desc: str | None = None, total: int | None = None):
    """tqdm progress bar over an iterable, degrading to the plain iterable
    when tqdm is unavailable (reference host-side bars:
    pssgp/experiments/toy_models/speed_and_stability.py:75-80)."""
    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover - tqdm ships in the image
        return iterable
    return tqdm(iterable, desc=desc, total=total)


class ModelEnum(enum.Enum):
    GP = "gp"  # dense GPR oracle
    SSGP = "ssgp"  # sequential state-space engine
    PSSGP = "pssgp"  # parallel (associative-scan) engine


class CovarianceEnum(enum.Enum):
    Matern12 = "Matern12"
    Matern32 = "Matern32"
    Matern52 = "Matern52"
    RBF = "RBF"
    QP = "QP"


class MCMCEnum(enum.Enum):
    HMC = "hmc"
    MALA = "mala"
    NUTS = "nuts"


def set_dtype(dtype: str, platform: str | None = None) -> None:
    """Configure precision and (optionally) the JAX platform.

    The reference selects devices with a ``--device`` flag
    (pssgp/experiments/common.py:41); here ``--platform`` plays that role.
    ``cpu`` forces the host; anything else keeps JAX's default platform,
    which prefers the accelerator — in float64 too, since the GPU computes
    float64 natively.  Must run before any JAX backend initialization.
    """
    import jax

    jax.config.update("jax_enable_x64", dtype == "float64")
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")

    from parallel_gps_tpu.config import enable_compilation_cache

    enable_compilation_cache()


def get_covariance_function(
    kind: str,
    variance: float = 1.0,
    lengthscales: float = 1.0,
    rbf_order: int = 6,
    rbf_balance_iter: int = 10,
    qp_order: int = 3,
    period: float = 1.0,
):
    """Simple covariance factory (reference: common.py:44-57).

    QP is the quasi-periodic composite Periodic(SE) * Matern32 used by the
    CO2/sunspot studies (reference: co2/mcmc.py:55-64).
    """
    from parallel_gps_tpu import kernels

    kind = CovarianceEnum(kind)
    if kind in (CovarianceEnum.Matern12, CovarianceEnum.Matern32, CovarianceEnum.Matern52):
        cls = getattr(kernels, kind.value)
        return cls(variance=variance, lengthscales=lengthscales)
    if kind == CovarianceEnum.RBF:
        return kernels.RBF(
            variance=variance,
            lengthscales=lengthscales,
            order=rbf_order,
            balancing_iter=rbf_balance_iter,
        )
    if kind == CovarianceEnum.QP:
        periodic = kernels.Periodic(
            variance=variance,
            lengthscales=lengthscales,
            period=period,
            order=qp_order,
        )
        return periodic * kernels.Matern32(
            variance=1.0, lengthscales=lengthscales
        )
    raise ValueError(f"unknown covariance {kind}")


def resolve_model_device(model: str, platform: str | None, dtype: str):
    """Per-model-kind device placement INSIDE one process — the reference's
    study protocol maps GP→/gpu:1, SSGP→/cpu:0, PSSGP→/gpu:0 in the same
    run (pssgp/experiments/toy_models/speed_and_stability.py:71-95 +
    speed_and_stability.sh).  Here the split is: sequential-engine SSGP →
    host CPU, scan-parallel PSSGP and the dense GP → the accelerator
    (JAX's default device).  Returns a ``jax.Device`` to pin the model's
    arrays to, or ``None`` for default placement.

    An explicit ``--platform cpu`` already runs the whole process on CPU,
    so the split collapses to ``None`` there.  ``dtype`` does not change
    the placement: the accelerator runs float64 natively.
    """
    import jax

    del dtype
    if platform == "cpu":
        return None
    if ModelEnum(model) == ModelEnum.SSGP:
        return jax.devices("cpu")[0]
    return None


def model_device_from_args(args):
    """--split-devices → the per-model device for ``get_model(device=…)``."""
    if not getattr(args, "split_devices", False):
        return None
    return resolve_model_device(args.model, args.platform, args.dtype)


def get_model(
    model: str,
    data,
    covariance,
    noise_variance: float,
    device=None,
    stable: bool = False,
):
    """Model factory (reference: common.py:60-71).  ``device`` pins the
    model's arrays (committed placement — jit follows committed inputs), so
    different models of one sweep can run on different devices in a single
    process (see resolve_model_device).  ``stable`` (``--stable``) routes
    the state-space models through the square-root engine — the f32
    stability sweep axis the reference covers by switching to float64."""
    import jax

    from parallel_gps_tpu.models import GPR, StateSpaceGP

    model = ModelEnum(model)
    if model == ModelEnum.GP:
        import jax.numpy as jnp

        from parallel_gps_tpu.config import default_float

        dtype = default_float()
        ts, ys = data
        built = GPR(
            ts=jnp.asarray(ts, dtype).reshape(-1, 1),
            ys=jnp.asarray(ys, dtype).reshape(-1, 1),
            kernel=covariance,
            noise_variance=jnp.asarray(noise_variance, dtype),
        )
    else:
        built = StateSpaceGP.create(
            data,
            covariance,
            noise_variance=noise_variance,
            parallel=model == ModelEnum.PSSGP,
            stable=stable and model == ModelEnum.PSSGP,
        )
    if device is not None:
        built = jax.device_put(built, device)
    return built


def run_one_mcmc(
    model,
    priors: dict | None,
    algo: str = "hmc",
    n_samples: int = 1000,
    burnin: int = 100,
    step_size: float = 0.01,
    num_leapfrog_steps: int = 10,
    seed: int = 0,
    trainable=None,
    progress: bool | int = False,
    warmup: int = 0,
):
    """Sample hyperparameter posteriors; returns (samples_unconstrained pytree,
    acceptance_rate, wall_seconds).  Failures record NaNs and keep going —
    the sweep convention of the reference (common.py:74-92).

    ``warmup`` > 0 runs that many dual-averaging adaptation steps first
    (inference.mcmc.dual_averaging_warmup) and replaces ``step_size`` with
    the adapted value, starting the chain from the warmed position — the
    opt-in upgrade over the reference's fixed-step protocol (which
    demonstrably collapses at n=16k, BASELINE.md toy MCMC row).  The
    acceptance statistic reported is the (trajectory-mean) Metropolis
    acceptance probability, TFP-comparable.

    ``progress``: in-chain progress reporting (the reference's TFP
    ``ProgressBarReducer``, common.py:117-121).  The fully-jitted chain
    cannot call back mid-``lax.scan``, so the run is split into segments
    (``progress`` as an int = segment count, True = 10) with a tqdm update
    between segments; each segment resumes from the previous final state, so
    results are a valid chain (the RNG stream differs from the unsegmented
    run by the extra key splits)."""
    import jax
    from jax.flatten_util import ravel_pytree

    from parallel_gps_tpu.inference import sample_chain
    from parallel_gps_tpu.inference.mcmc import make_kernel
    from parallel_gps_tpu.inference.optim import make_log_posterior

    log_post, u0 = make_log_posterior(model, priors, trainable=trainable)
    _, unravel = ravel_pytree(u0)
    log_post_flat = lambda x: log_post(unravel(x))  # noqa: E731
    rng = jax.random.PRNGKey(seed)
    t0 = time.time()
    if warmup > 0:
        from parallel_gps_tpu.inference import dual_averaging_warmup

        rng, k_warm = jax.random.split(rng)
        step_size, u0 = dual_averaging_warmup(
            lambda eps: make_kernel(
                algo, log_post_flat, eps,
                num_leapfrog_steps=num_leapfrog_steps,
            ),
            u0,
            log_post,
            k_warm,
            num_warmup=warmup,
        )
    kernel = make_kernel(
        algo,
        log_post_flat,
        step_size,
        num_leapfrog_steps=num_leapfrog_steps,
    )
    try:
        if not progress:
            samples, accept = sample_chain(
                kernel, u0, log_post, rng, n_samples, burnin
            )
        else:
            n_segments = 10 if progress is True else int(progress)
            seg = max(1, n_samples // n_segments)
            progress_bar = None
            try:
                from tqdm import tqdm

                progress_bar = tqdm(total=n_samples, desc=f"{algo} chain")
            except ImportError:  # pragma: no cover
                pass
            pieces, accepts = [], []
            position, done = u0, 0
            while done < n_samples:
                n_i = min(seg, n_samples - done)
                rng, key = jax.random.split(rng)
                s_i, a_i = sample_chain(
                    kernel, position, log_post, key, n_i,
                    burnin if done == 0 else 0,
                )
                jax.block_until_ready(a_i)
                position = jax.tree.map(lambda x: x[-1], s_i)
                pieces.append(s_i)
                accepts.append(np.asarray(a_i))
                done += n_i
                if progress_bar is not None:
                    progress_bar.update(n_i)
            if progress_bar is not None:
                progress_bar.close()
            samples = jax.tree.map(
                lambda *xs: np.concatenate([np.asarray(x) for x in xs]),
                *pieces,
            )
            accept = np.concatenate(accepts)
        jax.block_until_ready(samples)
        wall = time.time() - t0
        return samples, float(np.mean(np.asarray(accept))), wall
    except Exception as err:  # noqa: BLE001 — NaN-on-failure sweep convention
        print(f"MCMC failed: {err!r}")
        nan_samples = jax.tree.map(
            lambda x: np.full((n_samples,) + np.shape(x), np.nan), u0
        )
        return nan_samples, float("nan"), time.time() - t0


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model", default="pssgp", choices=[m.value for m in ModelEnum])
    p.add_argument("--cov", default="Matern32", choices=[c.value for c in CovarianceEnum])
    p.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    p.add_argument(
        "--platform",
        default="default",
        help="JAX platform: cpu, or default (the accelerator if any)",
    )
    p.add_argument("--noise-variance", type=float, default=0.5)
    p.add_argument(
        "--stable",
        action="store_true",
        help="square-root (Cholesky-factor) engine for the state-space "
        "models: PSD covariances at any conditioning (the f32 answer to "
        "the reference's float64 stability switch); ~2-3x the flops",
    )
    p.add_argument("--rbf-order", type=int, default=6)
    p.add_argument("--rbf-balance-iter", type=int, default=10)
    p.add_argument("--qp-order", type=int, default=3)
    p.add_argument("--out-dir", default="results")
    p.add_argument("--progress", action="store_true",
                   help="in-chain tqdm progress (segmented sampling)")
    p.add_argument(
        "--split-devices",
        action="store_true",
        help="reference-protocol per-model device split in one process: "
        "ssgp→host CPU, pssgp/gp→accelerator (accelerator runs only)",
    )
    p.add_argument("--data-dir", default=None)
    return p


def load_samples(npz_path: str, model):
    """Rebuild the unconstrained-sample pytree saved by the MCMC experiments
    (flattened ``sample_{j}`` leaves) for a model with the same hyperparameter
    structure — the reload half of the reference's --plot paths
    (pssgp/experiments/sunspot/mcmc.py:77-99)."""
    import jax

    from parallel_gps_tpu.models.params import as_arrays, unconstrain

    hypers0 = as_arrays(
        unconstrain({"kernel": model.kernel, "noise_variance": model.noise_variance})
    )
    leaves, treedef = jax.tree_util.tree_flatten(hypers0)
    with np.load(npz_path) as data:
        saved = [data[f"sample_{j}"] for j in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, saved)


def save_results(out_dir: str, name: str, **arrays) -> str:
    import os

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".npz")
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
    print(f"saved {path}")
    return path
