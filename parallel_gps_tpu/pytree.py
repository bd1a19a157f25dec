"""Frozen dataclasses registered as JAX pytrees.

Kernels and models are immutable dataclasses whose array fields are pytree
leaves, so they pass straight through ``jit`` / ``grad`` / ``vmap``.
Fields declared with ``field(pytree_node=False)`` are static: they live in
the treedef (part of every jit cache key) rather than among the leaves.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` with a ``pytree_node`` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    """Copy with the given fields replaced (the instance is frozen)."""
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass, register it as a pytree and give it
    a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if f.metadata.get("pytree_node", True)],
        meta_fields=[
            f.name for f in fields if not f.metadata.get("pytree_node", True)
        ],
    )
    cls.replace = _replace
    return cls
