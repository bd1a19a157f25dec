"""MCMC kernels over unconstrained hyperparameters: HMC, MALA, NUTS.

The reference drives TFP's HamiltonianMonteCarlo / MALA / NoUTurnSampler
through GPflow's SamplingHelper (reference: pssgp/experiments/common.py:95-133).
Here the samplers are self-contained JAX, fully jittable, and vmappable over
chains; positions are pytrees, raveled internally to flat vectors.

NUTS is the multinomial variant (Betancourt 2017) with iterative tree
building: within-subtree U-turn checks use the aligned-block checkpoint
scheme (leaf i closes every block of size 2^k with (i+1) ≡ 0 mod 2^k; its
left endpoint was checkpointed when encountered), so detailed balance holds
without recursion.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


class ChainState(NamedTuple):
    position: jax.Array  # flat
    log_prob: jax.Array
    grad: jax.Array  # flat


def _init_state(log_prob_fn, position_flat):
    lp, g = jax.value_and_grad(log_prob_fn)(position_flat)
    return ChainState(position_flat, lp, g)


def _leapfrog(log_prob_fn, state: ChainState, momentum, step_size, n_steps):
    def body(_, carry):
        q, p, g = carry
        p = p + 0.5 * step_size * g
        q = q + step_size * p
        lp, g = jax.value_and_grad(log_prob_fn)(q)
        p = p + 0.5 * step_size * g
        return (q, p, g)

    q, p, g = jax.lax.fori_loop(
        0, n_steps, body, (state.position, momentum, state.grad)
    )
    lp = log_prob_fn(q)
    return ChainState(q, lp, g), p


def hmc_kernel(
    log_prob_fn: Callable, step_size: float, num_leapfrog_steps: int = 10
):
    """Hamiltonian Monte Carlo (reference analogue: common.py:100-105)."""

    def step(rng, state: ChainState):
        k1, k2 = jax.random.split(rng)
        p0 = jax.random.normal(k1, state.position.shape, state.position.dtype)
        new, p = _leapfrog(log_prob_fn, state, p0, step_size, num_leapfrog_steps)
        log_accept = (
            new.log_prob
            - state.log_prob
            - 0.5 * jnp.sum(p**2)
            + 0.5 * jnp.sum(p0**2)
        )
        accept = jnp.log(jax.random.uniform(k2, dtype=state.log_prob.dtype)) < log_accept
        out = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b), new, state
        )
        return out, _accept_prob(log_accept)

    return step


def _accept_prob(log_accept):
    """Metropolis acceptance probability min(1, exp(log_accept)) — the
    TFP-comparable per-step statistic (its mean is what the reference's
    protocol logs, pssgp/experiments/common.py:83); NaN energies count 0."""
    a = jnp.exp(jnp.minimum(log_accept, 0.0))
    return jnp.where(jnp.isnan(a), jnp.zeros_like(a), a)


def mala_kernel(log_prob_fn: Callable, step_size: float):
    """Metropolis-adjusted Langevin (reference analogue: common.py:106-110)."""

    def step(rng, state: ChainState):
        k1, k2 = jax.random.split(rng)
        noise = jax.random.normal(k1, state.position.shape, state.position.dtype)
        # Proposal: q' = q + (ε²/2) ∇logπ(q) + ε ξ.
        eps2 = step_size**2
        mean_fwd = state.position + 0.5 * eps2 * state.grad
        q_new = mean_fwd + step_size * noise
        lp_new, g_new = jax.value_and_grad(log_prob_fn)(q_new)
        mean_bwd = q_new + 0.5 * eps2 * g_new
        log_q_fwd = -0.5 * jnp.sum((q_new - mean_fwd) ** 2) / eps2
        log_q_bwd = -0.5 * jnp.sum((state.position - mean_bwd) ** 2) / eps2
        log_accept = lp_new - state.log_prob + log_q_bwd - log_q_fwd
        accept = jnp.log(jax.random.uniform(k2, dtype=lp_new.dtype)) < log_accept
        new = ChainState(q_new, lp_new, g_new)
        out = jax.tree.map(lambda a, b: jnp.where(accept, a, b), new, state)
        return out, _accept_prob(log_accept)

    return step


# --------------------------------------------------------------------------
# NUTS (multinomial, iterative)
# --------------------------------------------------------------------------


class _TreeState(NamedTuple):
    # endpoints of the overall trajectory
    q_left: jax.Array
    p_left: jax.Array
    g_left: jax.Array
    q_right: jax.Array
    p_right: jax.Array
    g_right: jax.Array
    # current proposal (multinomially sampled from the trajectory)
    q_prop: jax.Array
    lp_prop: jax.Array
    g_prop: jax.Array
    log_weight: jax.Array  # logsumexp of -energy over the trajectory
    depth: jax.Array
    turning: jax.Array
    diverging: jax.Array
    sum_alpha: jax.Array  # Σ min(1, e^{E0−E}) over visited leaves
    n_alpha: jax.Array  # number of visited leaves
    rng: jax.Array


def _is_turning(q_minus, p_minus, q_plus, p_plus):
    dq = q_plus - q_minus
    return (jnp.dot(dq, p_minus) < 0.0) | (jnp.dot(dq, p_plus) < 0.0)


def nuts_kernel(
    log_prob_fn: Callable, step_size: float, max_depth: int = 8
):
    """No-U-Turn sampler (reference analogue: common.py:111-116)."""

    max_leaves = 2**max_depth

    def one_leapfrog(q, p, g):
        p = p + 0.5 * step_size * g
        q = q + step_size * p
        lp, g = jax.value_and_grad(log_prob_fn)(q)
        p = p + 0.5 * step_size * g
        return q, p, g, lp

    def build_subtree(rng, q, p, g, depth, energy0):
        """Sequentially add 2^depth leaves starting from (q,p,g), with
        aligned-block U-turn checks via per-level checkpoints.

        Returns subtree endpoints/proposal/log-weight/turning/diverging.
        """
        dim = q.shape[0]
        n_leaves = 2**max_depth  # static bound; loop is masked by `depth`

        class Carry(NamedTuple):
            i: jax.Array
            q: jax.Array
            p: jax.Array
            g: jax.Array
            # first leaf (left endpoint of the subtree)
            qL: jax.Array
            pL: jax.Array
            gL: jax.Array
            # proposal reservoir
            q_prop: jax.Array
            lp_prop: jax.Array
            g_prop: jax.Array
            log_w: jax.Array
            turning: jax.Array
            diverging: jax.Array
            sum_alpha: jax.Array
            n_alpha: jax.Array
            ckpt_q: jax.Array  # (max_depth+1, dim) left endpoints per level
            ckpt_p: jax.Array
            rng: jax.Array

        def cond(c: Carry):
            return (
                (c.i < (1 << depth).astype(c.i.dtype))
                & ~c.turning
                & ~c.diverging
            )

        def body(c: Carry):
            q, p, g, lp = one_leapfrog(c.q, c.p, c.g)
            energy = -lp + 0.5 * jnp.sum(p**2)
            log_w_leaf = energy0 - energy
            diverging = c.diverging | (log_w_leaf < -1000.0) | jnp.isnan(energy)
            # Trajectory-mean Metropolis acceptance (Stan's accept_stat).
            sum_alpha = c.sum_alpha + _accept_prob(log_w_leaf)
            n_alpha = c.n_alpha + 1.0

            # Reservoir (multinomial) proposal update.
            rng, k = jax.random.split(c.rng)
            log_w_new = jnp.logaddexp(c.log_w, log_w_leaf)
            take = (
                jnp.log(jax.random.uniform(k, dtype=log_w_new.dtype))
                < log_w_leaf - log_w_new
            )
            q_prop = jnp.where(take, q, c.q_prop)
            lp_prop = jnp.where(take, lp, c.lp_prop)
            g_prop = jnp.where(take, g, c.g_prop)

            i = c.i
            is_first = i == 0
            qL = jnp.where(is_first, q, c.qL)
            pL = jnp.where(is_first, p, c.pL)
            gL = jnp.where(is_first, g, c.gL)

            # Checkpoint: leaf i is the left endpoint of every aligned block
            # of size 2^k with i ≡ 0 (mod 2^k).
            ckpt_q, ckpt_p = c.ckpt_q, c.ckpt_p
            for k_lvl in range(1, max_depth + 1):
                write = (i % (1 << k_lvl)) == 0
                ckpt_q = ckpt_q.at[k_lvl].set(
                    jnp.where(write, q, ckpt_q[k_lvl])
                )
                ckpt_p = ckpt_p.at[k_lvl].set(
                    jnp.where(write, p, ckpt_p[k_lvl])
                )

            # U-turn checks: leaf i closes every block of size 2^k with
            # (i+1) ≡ 0 (mod 2^k), k ≥ 1; compare against its checkpoint.
            turning = c.turning
            for k_lvl in range(1, max_depth + 1):
                close = ((i + 1) % (1 << k_lvl)) == 0
                turn_k = _is_turning(ckpt_q[k_lvl], ckpt_p[k_lvl], q, p)
                turning = turning | (close & turn_k)

            return Carry(
                i=i + 1,
                q=q,
                p=p,
                g=g,
                qL=qL,
                pL=pL,
                gL=gL,
                q_prop=q_prop,
                lp_prop=lp_prop,
                g_prop=g_prop,
                log_w=log_w_new,
                turning=turning,
                diverging=diverging,
                sum_alpha=sum_alpha,
                n_alpha=n_alpha,
                ckpt_q=ckpt_q,
                ckpt_p=ckpt_p,
                rng=rng,
            )

        dtype = q.dtype
        init = Carry(
            i=jnp.zeros((), jnp.int32),
            q=q,
            p=p,
            g=g,
            qL=q,
            pL=p,
            gL=g,
            q_prop=q,
            lp_prop=jnp.asarray(-jnp.inf, dtype),
            g_prop=g,
            log_w=jnp.asarray(-jnp.inf, dtype),
            turning=jnp.zeros((), bool),
            diverging=jnp.zeros((), bool),
            sum_alpha=jnp.zeros((), dtype),
            n_alpha=jnp.zeros((), dtype),
            ckpt_q=jnp.zeros((max_depth + 1, dim), dtype),
            ckpt_p=jnp.zeros((max_depth + 1, dim), dtype),
            rng=rng,
        )
        out = jax.lax.while_loop(cond, body, init)
        return out

    def step(rng, state: ChainState):
        dtype = state.position.dtype
        rng, k_mom, k_loop = jax.random.split(rng, 3)
        p0 = jax.random.normal(k_mom, state.position.shape, dtype)
        energy0 = -state.log_prob + 0.5 * jnp.sum(p0**2)

        tree = _TreeState(
            q_left=state.position,
            p_left=-p0,  # momentum pointing backwards for the left expansion
            g_left=state.grad,
            q_right=state.position,
            p_right=p0,
            g_right=state.grad,
            q_prop=state.position,
            lp_prop=state.log_prob,
            g_prop=state.grad,
            log_weight=jnp.zeros((), dtype),  # energy0 - energy0
            depth=jnp.zeros((), jnp.int32),
            turning=jnp.zeros((), bool),
            diverging=jnp.zeros((), bool),
            sum_alpha=jnp.zeros((), dtype),
            n_alpha=jnp.zeros((), dtype),
            rng=k_loop,
        )

        def cond(t: _TreeState):
            return (t.depth < max_depth) & ~t.turning & ~t.diverging

        def body(t: _TreeState):
            rng, k_dir, k_take, k_sub = jax.random.split(t.rng, 4)
            go_right = jax.random.bernoulli(k_dir)

            q0 = jnp.where(go_right, t.q_right, t.q_left)
            p0_ = jnp.where(go_right, t.p_right, t.p_left)
            g0 = jnp.where(go_right, t.g_right, t.g_left)

            sub = build_subtree(k_sub, q0, p0_, g0, t.depth, energy0)

            # New overall endpoint in the chosen direction.
            q_right = jnp.where(go_right, sub.q, t.q_right)
            p_right = jnp.where(go_right, sub.p, t.p_right)
            g_right = jnp.where(go_right, sub.g, t.g_right)
            q_left = jnp.where(go_right, t.q_left, sub.q)
            p_left = jnp.where(go_right, t.p_left, sub.p)
            g_left = jnp.where(go_right, t.g_left, sub.g)

            bad = sub.turning | sub.diverging
            # Biased progressive sampling between old tree and new subtree.
            take_new = (
                jnp.log(jax.random.uniform(k_take, dtype=dtype))
                < sub.log_w - t.log_weight
            ) & ~bad
            q_prop = jnp.where(take_new, sub.q_prop, t.q_prop)
            lp_prop = jnp.where(take_new, sub.lp_prop, t.lp_prop)
            g_prop = jnp.where(take_new, sub.g_prop, t.g_prop)
            log_weight = jnp.where(
                bad, t.log_weight, jnp.logaddexp(t.log_weight, sub.log_w)
            )

            turning = (
                bad
                | _is_turning(q_left, -p_left, q_right, p_right)
            )
            return _TreeState(
                q_left=q_left,
                p_left=p_left,
                g_left=g_left,
                q_right=q_right,
                p_right=p_right,
                g_right=g_right,
                q_prop=q_prop,
                lp_prop=lp_prop,
                g_prop=g_prop,
                log_weight=log_weight,
                depth=t.depth + 1,
                turning=turning,
                diverging=t.diverging | sub.diverging,
                sum_alpha=t.sum_alpha + sub.sum_alpha,
                n_alpha=t.n_alpha + sub.n_alpha,
                rng=rng,
            )

        out = jax.lax.while_loop(cond, body, tree)
        new = ChainState(out.q_prop, out.lp_prop, out.g_prop)
        # Trajectory-mean Metropolis acceptance over all visited leaves —
        # the statistic TFP/Stan report (and what dual averaging targets);
        # replaces the crude any(position changed) indicator.
        accept_stat = out.sum_alpha / jnp.maximum(out.n_alpha, 1.0)
        return new, accept_stat

    del max_leaves
    return step


# --------------------------------------------------------------------------
# Chain driver
# --------------------------------------------------------------------------


def sample_chain(
    kernel_step: Callable,
    initial_position,
    log_prob_fn_tree: Callable,
    rng: jax.Array,
    num_samples: int,
    num_burnin: int = 0,
):
    """Run one chain; returns (samples pytree stacked on axis 0,
    acceptance statistic per step — the (trajectory-mean) Metropolis
    acceptance probability, whose mean matches TFP's logged rate).

    ``initial_position`` is a pytree; ``log_prob_fn_tree`` takes the pytree.
    The reference analogue is TFP's ``sample_chain``
    (pssgp/experiments/common.py:123-131).  Fully jitted ``lax.scan``;
    vmap over (rng, initial_position) for multiple chains.
    """
    flat0, unravel = ravel_pytree(initial_position)

    def log_prob_flat(x):
        return log_prob_fn_tree(unravel(x))

    state0 = _init_state(log_prob_flat, flat0)

    def one(state, key):
        state, accepted = kernel_step(key, state)
        return state, (state.position, accepted)

    keys = jax.random.split(rng, num_samples + num_burnin)

    @jax.jit
    def run(state0, keys):
        _, (positions, accepted) = jax.lax.scan(one, state0, keys)
        return positions[num_burnin:], accepted[num_burnin:]

    positions, accepted = run(state0, keys)
    samples = jax.vmap(unravel)(positions)
    return samples, accepted


def make_kernel(name: str, log_prob_flat, step_size, **kwargs):
    """Factory mirroring the reference's MCMC enum (common.py:21-25).

    ``step_size`` may be a traced scalar — the kernels use it purely
    arithmetically — which is what lets dual averaging adapt it inside a
    single compiled warmup scan."""
    name = name.upper()
    if name == "HMC":
        return hmc_kernel(
            log_prob_flat, step_size, kwargs.get("num_leapfrog_steps", 10)
        )
    if name == "MALA":
        return mala_kernel(log_prob_flat, step_size)
    if name == "NUTS":
        return nuts_kernel(log_prob_flat, step_size, kwargs.get("max_depth", 8))
    raise ValueError(f"unknown MCMC kernel: {name}")


# --------------------------------------------------------------------------
# Step-size adaptation (opt-in): Nesterov dual averaging (Hoffman & Gelman
# 2014, Algorithm 5/6).  The reference runs fixed step sizes only — its toy
# protocol demonstrably collapses at n=16k (BASELINE.md toy MCMC row); this
# is an opt-in upgrade, exposed via run_one_mcmc(warmup=...).
# --------------------------------------------------------------------------


def find_reasonable_step_size(
    log_prob_flat: Callable, state: ChainState, rng: jax.Array,
    init: float = 1.0, max_iters: int = 60,
):
    """Algorithm 4 of Hoffman & Gelman: from ``init``, double (halve) the
    step size until the one-leapfrog acceptance probability crosses 1/2.
    Fully jittable (lax.while_loop); NaN energies count as acceptance 0."""
    dtype = state.position.dtype
    p0 = jax.random.normal(rng, state.position.shape, dtype)
    k0 = 0.5 * jnp.sum(p0**2)

    def log_alpha(eps):
        new, p = _leapfrog(log_prob_flat, state, p0, eps, 1)
        la = new.log_prob - state.log_prob - 0.5 * jnp.sum(p**2) + k0
        return jnp.where(jnp.isnan(la), -jnp.inf, la)

    log2 = jnp.asarray(jnp.log(2.0), dtype)
    a = jnp.where(log_alpha(jnp.asarray(init, dtype)) > -log2, 1.0, -1.0)

    def cond(c):
        eps, it = c
        return (a * log_alpha(eps) > -a * log2) & (it < max_iters)

    def body(c):
        eps, it = c
        return eps * jnp.exp(a * log2), it + 1

    eps, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(init, dtype), jnp.zeros((), jnp.int32))
    )
    return eps


def dual_averaging_warmup(
    make_step: Callable,
    initial_position,
    log_prob_fn_tree: Callable,
    rng: jax.Array,
    num_warmup: int = 500,
    target_accept: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
    init_step_size: float | None = None,
):
    """Adapt the step size over ``num_warmup`` iterations; returns
    (step_size, warmed position pytree).

    ``make_step(eps)`` must build a kernel step (e.g.
    ``lambda e: make_kernel("nuts", lp_flat, e)``) whose second return is
    the acceptance statistic the adaptation targets — the kernels here all
    return the (trajectory-mean) Metropolis acceptance probability.  One
    compiled ``lax.scan``; ``eps`` is traced through the kernel."""
    flat0, unravel = ravel_pytree(initial_position)

    def log_prob_flat(x):
        return log_prob_fn_tree(unravel(x))

    state0 = _init_state(log_prob_flat, flat0)
    dtype = flat0.dtype
    rng, k_find = jax.random.split(rng)
    if init_step_size is None:
        eps0 = find_reasonable_step_size(log_prob_flat, state0, k_find)
    else:
        eps0 = jnp.asarray(init_step_size, dtype)
    mu = jnp.log(10.0 * eps0)

    def one(carry, key):
        state, m, log_eps, log_eps_bar, h_bar = carry
        step = make_step(jnp.exp(log_eps))
        state, alpha = step(key, state)
        alpha = jnp.clip(alpha.astype(dtype), 0.0, 1.0)
        m = m + 1.0
        h_bar = (1.0 - 1.0 / (m + t0)) * h_bar + (target_accept - alpha) / (
            m + t0
        )
        log_eps = mu - jnp.sqrt(m) / gamma * h_bar
        eta = m**-kappa
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
        return (state, m, log_eps, log_eps_bar, h_bar), alpha

    keys = jax.random.split(rng, num_warmup)

    @jax.jit
    def run(state0, eps0, keys):
        init = (
            state0,
            jnp.zeros((), dtype),
            jnp.log(eps0),
            jnp.log(eps0),
            jnp.zeros((), dtype),
        )
        (state, _, _, log_eps_bar, _), alphas = jax.lax.scan(one, init, keys)
        return state, jnp.exp(log_eps_bar), alphas

    state, eps, _ = run(state0, eps0, keys)
    return eps, unravel(state.position)


def sample_chains(
    kernel_step: Callable,
    initial_positions,
    log_prob_fn_tree: Callable,
    rng: jax.Array,
    num_samples: int,
    num_burnin: int = 0,
    chunk_size: int | None = None,
):
    """Run multiple chains in parallel with ``vmap`` — the batching the
    reference's single TFP chain lacks (SURVEY.md §2 checklist, "data
    parallelism over MCMC chains").

    ``initial_positions`` is a pytree whose leaves carry a leading chain
    axis.  Returns (samples stacked (num_chains, num_samples, ...),
    is_accepted (num_chains, num_samples)).  Compose with a sharded mesh by
    jitting under a ``NamedSharding`` over the chain axis.

    ``chunk_size``: None (default) runs all chains as one vmap.  An int runs
    wider chain counts as ``lax.map`` over vmapped chunks of that size —
    same results, one compile, less peak memory.  Chain counts that are not
    a multiple of ``chunk_size`` are padded up with duplicated chains (their
    draws are discarded).  On an NVIDIA H100 80GB HBM3 (700 W limit) the
    batched LML + grad of 64 Matern32 chains × T=65,536 took 22.5 ms as one
    vmap and 26.1 ms in chunks of 32 (peak 1.3 GiB vs 0.6 GiB), so one vmap
    is the default.
    """
    n_chains = jax.tree.leaves(initial_positions)[0].shape[0]

    def run_one(pos, key):
        return sample_chain(
            kernel_step, pos, log_prob_fn_tree, key, num_samples, num_burnin
        )

    if chunk_size is None or n_chains <= chunk_size:
        keys = jax.random.split(rng, n_chains)
        return jax.vmap(run_one)(initial_positions, keys)

    n_chunks = -(-n_chains // chunk_size)
    n_pad = n_chunks * chunk_size
    # Real chains keep the same per-chain keys as the monolithic path
    # (bitwise-identical draws); pad chains duplicate the last one and are
    # discarded below.
    keys = jax.random.split(rng, n_chains)

    def padded(x):
        if n_pad != n_chains:
            reps = jnp.broadcast_to(
                x[-1:], (n_pad - n_chains,) + x.shape[1:]
            )
            x = jnp.concatenate([x, reps], axis=0)
        return x.reshape((n_chunks, chunk_size) + x.shape[1:])

    pos_c = jax.tree.map(padded, initial_positions)
    out = jax.lax.map(
        lambda args: jax.vmap(run_one)(*args), (pos_c, padded(keys))
    )
    return jax.tree.map(
        lambda x: x.reshape((n_pad,) + x.shape[2:])[:n_chains], out
    )
