"""Hyperparameter optimization: Adam and L-BFGS on the negative LML.

Replaces the reference's GPflow/scipy optimizer stack
(reference: pssgp/experiments/sunspot/map.py:74-83 — scipy L-BFGS host loop
around device loss/grad).  Here both optimizers run fully jitted on-device
(optax), with the whole loop a ``lax.scan`` — no per-step host round-trips.

Hyperparameters live in *unconstrained* space (see models/params.py); the
loss constrains before evaluating, exactly like GPflow's unconstrained
``trainable_variables``.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax

from parallel_gps_tpu.models.params import as_arrays, constrain, unconstrain


def make_loss(model) -> tuple[Callable, dict]:
    """Return (loss_fn, init_unconstrained_params) for a model pytree.

    ``loss_fn(u)`` = negative LML with ``u`` the unconstrained
    {kernel, noise_variance} pytree; the data stays closed over.
    """
    hypers0 = as_arrays(
        unconstrain(
            {"kernel": model.kernel, "noise_variance": model.noise_variance}
        )
    )

    def loss(u):
        c = constrain(u)
        m = model.replace(kernel=c["kernel"], noise_variance=c["noise_variance"])
        return -m.log_marginal_likelihood()

    return loss, hypers0


def make_log_posterior(model, priors: dict | None = None, trainable=None):
    """Unnormalized log posterior over unconstrained hyperparameters:
    LML + Σ prior.log_prob(unconstrained leaf), the reference's MCMC target
    (pssgp/experiments/common.py:96-97 with PriorOn.UNCONSTRAINED,
    toy_models/mcmc.py:32-44).

    ``trainable`` is an optional predicate on dotted leaf paths; leaves it
    rejects are pinned to their initial values (the reference's
    ``set_trainable(x, False)``, e.g. co2/mcmc.py:35-39) and excluded from
    the sampled position.
    """
    from parallel_gps_tpu.models.params import log_prior, trainable_mask

    loss, hypers0 = make_loss(model)

    if trainable is None:

        def log_post(u):
            lp = -loss(u)
            if priors:
                lp = lp + log_prior(u, priors)
            return lp

        return log_post, hypers0

    mask = trainable_mask(hypers0, trainable)

    def log_post(u):
        merged = jax.tree.map(
            lambda m, a, b: a if m else b, mask, u, hypers0
        )
        lp = -loss(merged)
        if priors:
            lp = lp + log_prior(merged, priors)
        return lp

    return log_post, hypers0


def _with_priors(loss, priors: dict | None):
    """Negative log *posterior* loss: MAP objective when priors are given
    (reference: gpflow ``training_loss`` with priors, sunspot/map.py:74-83)."""
    if not priors:
        return loss
    from parallel_gps_tpu.models.params import log_prior

    def loss_map(u):
        return loss(u) - log_prior(u, priors)

    return loss_map


def fit_adam(
    model,
    n_iters: int = 200,
    learning_rate: float = 1e-2,
    trainable: Callable[[str], bool] | None = None,
    priors: dict | None = None,
):
    """Adam on negative LML (or negative log posterior with ``priors``);
    returns (fitted model, loss history)."""
    loss, u0 = make_loss(model)
    loss = _with_priors(loss, priors)
    opt = optax.adam(learning_rate)
    if trainable is not None:
        from parallel_gps_tpu.models.params import trainable_mask

        mask = trainable_mask(u0, trainable)
        opt = optax.chain(optax.masked(opt, mask))

    @jax.jit
    def run(u0):
        state0 = opt.init(u0)

        def step(carry, _):
            u, state = carry
            val, grads = jax.value_and_grad(loss)(u)
            updates, state = opt.update(grads, state, u)
            u = optax.apply_updates(u, updates)
            return (u, state), val

        (u, _), history = jax.lax.scan(step, (u0, state0), None, length=n_iters)
        return u, history

    u, history = run(u0)
    c = constrain(u)
    return (
        model.replace(kernel=c["kernel"], noise_variance=c["noise_variance"]),
        history,
    )


def fit_lbfgs(model, n_iters: int = 100, trainable=None, priors: dict | None = None):
    """L-BFGS (with zoom linesearch) on negative LML (or negative log
    posterior with ``priors`` — MAP), fully on-device — the jitted
    replacement for the reference's scipy host loop
    (pssgp/experiments/sunspot/map.py:81)."""
    loss, u0 = make_loss(model)
    loss = _with_priors(loss, priors)
    if trainable is not None:
        from parallel_gps_tpu.models.params import trainable_mask

        mask = trainable_mask(u0, trainable)
        frozen = u0

        def loss_masked(u):
            merged = jax.tree.map(
                lambda m, a, b: a if m else b, mask, u, frozen
            )
            return loss(merged)

        run_loss = loss_masked
    else:
        run_loss = loss

    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(run_loss)

    @jax.jit
    def run(u0):
        state0 = opt.init(u0)

        def step(carry, _):
            u, state = carry
            val, grad = value_and_grad(u, state=state)
            updates, state = opt.update(
                grad, state, u, value=val, grad=grad, value_fn=run_loss
            )
            u = optax.apply_updates(u, updates)
            return (u, state), val

        (u, _), history = jax.lax.scan(step, (u0, state0), None, length=n_iters)
        return u, history

    u, history = run(u0)
    if trainable is not None:
        from parallel_gps_tpu.models.params import trainable_mask

        mask = trainable_mask(u0, trainable)
        u = jax.tree.map(lambda m, a, b: a if m else b, mask, u, u0)
    c = constrain(u)
    return (
        model.replace(kernel=c["kernel"], noise_variance=c["noise_variance"]),
        history,
    )
