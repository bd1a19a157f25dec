"""Pytree checkpointing for hyperparameters, posteriors and sweep results.

The reference persists results ad hoc (``np.savez`` + an ``eval``-based
parameter restore, pssgp/experiments/sunspot/map.py:103-106 — explicitly NOT
reproduced, see SURVEY.md §5).  Here any JAX pytree round-trips through a
single ``.npz`` file: leaves are stored by flattened index plus a
version-stable structural fingerprint (the leaves' key paths — dict keys,
dataclass field names, sequence indices), and restoration fills a
caller-provided structure-matching pytree — no ``eval``, no pickling of code.
"""
from __future__ import annotations

import os

import jax
import numpy as np


def _key_paths(tree) -> list[str]:
    """Key path per leaf — a structural fingerprint that is stable across
    JAX versions (PyTreeDef repr is not: it changes with internal renames
    and dataclass cosmetics, which would hard-fail valid checkpoints)."""
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(p) for p, _ in paths]


def save_pytree(path: str, tree) -> None:
    """Save a pytree of arrays/scalars to ``path`` (.npz)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    payload = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    payload["__keypaths__"] = np.asarray(_key_paths(tree))
    payload["__treedef_repr__"] = np.asarray(repr(treedef))  # human-readable
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    np.savez(path, **payload)


def load_pytree(path: str, like):
    """Load a pytree saved by :func:`save_pytree`.

    ``like`` supplies the structure (its leaf values are ignored); leaf
    dtypes follow what was saved.  Structure is validated against the saved
    key paths (leaf names/positions) — a genuine mismatch raises; a
    PyTreeDef-repr difference alone (JAX version change) only warns.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        leaves, treedef = jax.tree_util.tree_flatten(like)
        # Checkpoints written before the sidecars existed have only
        # leaf_{i} keys — the leaf-count check still applies to those.
        n_saved = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_saved != len(leaves):
            raise ValueError(
                f"checkpoint structure mismatch: checkpoint has {n_saved} "
                f"leaves, 'like' has {len(leaves)}"
            )
        if "__keypaths__" in data.files:
            saved_paths = [str(p) for p in data["__keypaths__"]]
            like_paths = _key_paths(like)
            if saved_paths != like_paths:
                raise ValueError(
                    "checkpoint structure mismatch: saved leaf key paths\n"
                    f"  {saved_paths}\ndo not match the provided 'like' "
                    f"pytree's\n  {like_paths}"
                )
        elif "__treedef_repr__" in data.files:
            saved_repr = str(data["__treedef_repr__"])
            if saved_repr != repr(treedef):
                # Legacy checkpoints: repr is not stable across JAX
                # versions, so with a matching leaf count this is a warning,
                # not an error.
                import warnings

                warnings.warn(
                    "checkpoint treedef repr differs from the provided "
                    "'like' pytree (leaf counts match — likely a JAX "
                    f"version change):\n  saved: {saved_repr}\n"
                    f"  like:  {treedef!r}",
                    stacklevel=2,
                )
        saved = [data[f"leaf_{i}"] for i in range(len(leaves))]
        return jax.tree_util.tree_unflatten(treedef, saved)
