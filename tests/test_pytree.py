"""The in-repo frozen pytree dataclass (parallel_gps_tpu.pytree) that kernels
and models are built on."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallel_gps_tpu import pytree
from parallel_gps_tpu.kernels import Matern32, Matern52


@pytree.dataclass
class _Box:
    a: jax.Array
    b: jax.Array = 1.0
    tag: str = pytree.field(pytree_node=False, default="x")


def test_flatten_unflatten_roundtrip():
    box = _Box(jnp.arange(3.0), 2.0, tag="y")
    leaves, treedef = jax.tree_util.tree_flatten(box)
    assert len(leaves) == 2  # the static field is not a leaf
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, _Box) and back.tag == "y"
    np.testing.assert_array_equal(back.a, box.a)
    assert back.b == 2.0


def test_static_fields_live_in_the_treedef():
    t1 = jax.tree_util.tree_structure(_Box(1.0, tag="x"))
    t2 = jax.tree_util.tree_structure(_Box(5.0, tag="x"))
    t3 = jax.tree_util.tree_structure(_Box(1.0, tag="z"))
    assert t1 == t2 and t1 != t3
    m1 = jax.tree_util.tree_structure(Matern52(1.0, 1.0, balancing_iter=3))
    m2 = jax.tree_util.tree_structure(Matern52(1.0, 1.0, balancing_iter=4))
    assert m1 != m2


def test_replace_and_frozen():
    box = _Box(1.0)
    new = box.replace(b=3.0, tag="q")
    assert (new.a, new.b, new.tag) == (1.0, 3.0, "q")
    assert (box.b, box.tag) == (1.0, "x")  # original untouched
    with pytest.raises(dataclasses.FrozenInstanceError):
        box.a = 2.0


def test_key_paths_name_fields():
    """Parameter transforms (models/params.py) address leaves by field
    name through GetAttrKey paths."""
    k = Matern32(1.0, 0.5) + Matern52(2.0, 0.3)
    paths = [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(k)[0]
    ]
    assert paths == [
        ".kernels[0].variance", ".kernels[0].lengthscales",
        ".kernels[1].variance", ".kernels[1].lengthscales",
    ]


def test_jit_reuses_compile_across_leaf_values():
    @jax.jit
    def f(box):
        return box.a * box.b

    f(_Box(jnp.ones(3), 2.0))
    n = f._cache_size()
    f(_Box(4.0 * jnp.ones(3), 5.0))  # same treedef and shapes: no retrace
    assert f._cache_size() == n
    f(_Box(jnp.ones(3), 2.0, tag="other"))  # static field changed
    assert f._cache_size() == n + 1
