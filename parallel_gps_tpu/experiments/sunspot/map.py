"""Sunspot MAP experiment (reference: pssgp/experiments/sunspot/map.py):
L-BFGS MAP fit of Matern32 hyperparameters on the last n ∈ {1200, 2200, 3200}
months, then posterior smoothing prediction on a 30× dense interpolation grid
(up to 96,000 points).

The whole L-BFGS loop runs jitted on-device (optax) instead of a scipy host
loop.

Usage::

    python -m parallel_gps_tpu.experiments.sunspot.map --model pssgp \
        --data-dir /path/with/sunspots.csv
"""
from __future__ import annotations

import time

import numpy as np

from parallel_gps_tpu.experiments import common as C
from parallel_gps_tpu.experiments.sunspot.common import (
    get_covariance_function,
    get_data,
    get_priors,
)


def run(args) -> dict:
    import os

    if getattr(args, "no_run", False):
        if args.plot:
            from parallel_gps_tpu.experiments.plots import plot_map_prediction

            for n in args.sizes:
                plot_map_prediction(
                    os.path.join(
                        args.out_dir, f"sunspot_map_{args.model}_n{n}.npz"
                    )
                )
        return {}

    import jax

    C.set_dtype(args.dtype, args.platform)
    out = {}
    for n in args.sizes:
        t, y = get_data(n, args.data_dir)
        model = C.get_model(
            args.model, (t, y), get_covariance_function(), args.noise_variance,
            device=C.model_device_from_args(args), stable=args.stable,
        )
        from parallel_gps_tpu.inference import fit_lbfgs

        tic = time.time()
        fitted, history = fit_lbfgs(
            model, n_iters=args.maxiter, priors=get_priors(args.noise_variance)
        )
        jax.block_until_ready(history)
        wall = time.time() - tic

        n_pred = n * args.pred_factor
        t_pred = np.linspace(float(t.min()), float(t.max()), n_pred)
        tic = time.time()
        mean, var = fitted.predict_f(t_pred)
        jax.block_until_ready((mean, var))
        wall_pred = time.time() - tic
        print(
            f"n={n}: map_wall={wall:.1f}s loss={float(history[-1]):.2f} "
            f"pred({n_pred} pts)_wall={wall_pred:.1f}s"
        )
        path = C.save_results(
            args.out_dir,
            f"sunspot_map_{args.model}_n{n}",
            t=t,
            y=y,
            t_pred=t_pred,
            mean=np.asarray(mean),
            var=np.asarray(var),
            loss_history=np.asarray(history),
            wall=wall,
            wall_pred=wall_pred,
        )
        if args.plot:
            from parallel_gps_tpu.experiments.plots import plot_map_prediction

            plot_map_prediction(path)
        out[n] = (wall, wall_pred)
    return out


def main():
    p = C.base_parser(__doc__)
    p.add_argument("--sizes", type=int, nargs="+", default=[1200, 2200, 3200])
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--pred-factor", type=int, default=30)
    p.add_argument("--plot", action="store_true", help="regenerate the CI prediction figure")
    p.add_argument("--no-run", action="store_true", help="skip the fit (reload saved results)")
    p.set_defaults(noise_variance=300.0)
    run(p.parse_args())


if __name__ == "__main__":
    main()
