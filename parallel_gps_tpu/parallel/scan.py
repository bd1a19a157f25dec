"""Distributed (two-level / blockwise) associative scan over a device mesh.

This is the SSGP analogue of ring-attention for sequence scaling
(SURVEY.md §5 "long-context"): the time axis is sharded over a mesh axis, each
device runs a local XLA associative scan over its shard, the per-shard totals
are exchanged with one ``all_gather`` (P tiny (d,d) elements), every
device computes the exclusive prefix of the totals redundantly (P is small),
and finally combines its incoming prefix into its local results — a
distributed Blelloch scan with O(log(T/P)) local span + O(1) collectives.

The reference has no distributed execution at all (SURVEY.md §2 checklist);
this module is the new capability that lets N=10M+ time steps span hosts.

Works under ``jax.shard_map``; gradients flow because ``all_gather`` and the
element algebra are transposable by JAX.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from parallel_gps_tpu.ops.scan import blocked_associative_scan  # noqa: F401  (re-export)


def _exclusive_prefix(operator, totals, identity, my_idx):
    """Exclusive prefix of the gathered per-shard totals for this shard."""
    inclusive = jax.lax.associative_scan(operator, totals, axis=0)
    safe_idx = jnp.maximum(my_idx - 1, 0)
    prev = jax.tree.map(
        lambda x: jax.lax.dynamic_index_in_dim(x, safe_idx, 0, keepdims=False),
        inclusive,
    )
    return jax.tree.map(
        lambda p, i: jnp.where(my_idx == 0, i, p), prev, identity
    )


def sharded_associative_scan(
    operator: Callable,
    elems,
    axis_name: str,
    identity,
    reverse: bool = False,
):
    """Associative scan over leading axis 0 of ``elems`` whose global time
    axis is sharded over mesh axis ``axis_name``.

    Must be called *inside* a ``shard_map`` region: ``elems`` leaves carry the
    local shard (T/P, ...).  ``identity`` is the operator's identity element
    (leaves shaped like one element) — used as the incoming prefix of the
    first shard.

    For ``reverse=True`` the scan accumulates from the right (as the smoother
    needs); the incoming "prefix" then comes from the *next* shard.
    """
    if reverse:
        # Reverse scan semantics match jax.lax.associative_scan(reverse=True):
        # out[i] = ((e_{n-1} ∘ e_{n-2}) ∘ ...) ∘ e_i.  By associativity the
        # incoming "prefix" for shard k is the left-assoc combine of the
        # later shards' totals, applied on the LEFT of each local result.
        local = blocked_associative_scan(operator, elems, identity, reverse=True)
        total = jax.tree.map(lambda x: x[0], local)
        totals = jax.lax.all_gather(total, axis_name, axis=0)  # (P, ...)
        # Order totals from last shard to first, then take the exclusive
        # prefix for position (P-1 - my_idx) in that flipped ordering.
        totals = jax.tree.map(lambda x: jnp.flip(x, axis=0), totals)
        n_shards = jax.lax.axis_size(axis_name)
        my_idx = n_shards - 1 - jax.lax.axis_index(axis_name)
        prefix = _exclusive_prefix(operator, totals, identity, my_idx)
        prefix_b = jax.tree.map(lambda x: x[None], prefix)
        return operator(prefix_b, local)

    local = blocked_associative_scan(operator, elems, identity)
    total = jax.tree.map(lambda x: x[-1], local)
    totals = jax.lax.all_gather(total, axis_name, axis=0)  # (P, ...)
    my_idx = jax.lax.axis_index(axis_name)
    prefix = _exclusive_prefix(operator, totals, identity, my_idx)
    # Combine the incoming prefix into every local result (operators are
    # batched over leading dims; broadcast the prefix).
    prefix_b = jax.tree.map(lambda x: x[None], prefix)
    return operator(prefix_b, local)


def _exclusive_prefix_tl(operator, totals_tl, identity, my_idx):
    """Exclusive prefix over the LAST axis of gathered time-last totals."""
    from parallel_gps_tpu.kalman.timelast import kogge_stone_scan_tl

    inclusive = kogge_stone_scan_tl(operator, totals_tl, identity)
    safe_idx = jnp.maximum(my_idx - 1, 0)
    prev = jax.tree.map(
        lambda x: jax.lax.dynamic_index_in_dim(
            x, safe_idx, x.ndim - 1, keepdims=True
        ),
        inclusive,
    )
    return jax.tree.map(
        lambda p, i: jnp.where(my_idx == 0, i[..., None].astype(p.dtype), p),
        prev,
        identity,
    )


def sharded_associative_scan_tl(
    operator: Callable,
    elems,
    axis_name: str,
    identity,
    reverse: bool = False,
):
    """Time-last counterpart of :func:`sharded_associative_scan`: the global
    time axis is the LAST axis of every leaf (the layout of
    kalman.timelast), sharded over mesh axis ``axis_name``.  Must be called
    inside ``shard_map``.
    """
    from parallel_gps_tpu.kalman.timelast import kogge_stone_scan_tl

    local = kogge_stone_scan_tl(operator, elems, identity, reverse=reverse)
    pick = 0 if reverse else -1
    total = jax.tree.map(lambda x: x[..., pick], local)
    totals = jax.lax.all_gather(total, axis_name, axis=0)  # (P, ...)
    totals_tl = jax.tree.map(lambda x: jnp.moveaxis(x, 0, -1), totals)
    n_shards = jax.lax.axis_size(axis_name)
    if reverse:
        totals_tl = jax.tree.map(lambda x: jnp.flip(x, axis=-1), totals_tl)
        my_idx = n_shards - 1 - jax.lax.axis_index(axis_name)
    else:
        my_idx = jax.lax.axis_index(axis_name)
    prefix = _exclusive_prefix_tl(operator, totals_tl, identity, my_idx)
    prefix_b = jax.tree.map(
        lambda p, x: jnp.broadcast_to(p, x.shape), prefix, local
    )
    return operator(prefix_b, local)
