"""The in-repo pytree dataclass helper and the compile-cache location."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyfasst_jax.models.components import SpatialComp, SpectralComp
from pyfasst_jax.utils import compile_cache
from pyfasst_jax.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class _Pair:
    x: jnp.ndarray
    y: jnp.ndarray = None
    tag: str = static_field(default="a")


def test_leaves_are_array_fields_only():
    p = _Pair(x=jnp.ones(2), y=jnp.zeros(3), tag="b")
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert [leaf.shape for leaf in leaves] == [(2,), (3,)]
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.tag == "b"


def test_tree_map_keeps_static_fields():
    p = _Pair(x=jnp.ones(2), tag="c")
    q = jax.tree.map(lambda a: 2 * a, p)
    assert q.tag == "c" and q.y is None
    np.testing.assert_array_equal(q.x, 2 * np.ones(2))


def test_replace_and_frozen():
    p = _Pair(x=jnp.ones(2))
    q = p.replace(tag="z", y=jnp.ones(1))
    assert (p.tag, q.tag) == ("a", "z") and p.y is None
    with pytest.raises(Exception):
        p.tag = "no"


def test_static_fields_retrace_array_fields_do_not():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.tag)
        return p.x.sum()

    f(_Pair(x=jnp.ones(2)))
    f(_Pair(x=jnp.zeros(2)))            # new values, same structure
    assert traces == ["a"]
    f(_Pair(x=jnp.ones(2), tag="b"))    # static change -> retrace
    assert traces == ["a", "b"]


def test_model_components_are_pytrees():
    c = SpectralComp(FB=jnp.ones((3, 2)), TW=jnp.ones((2, 4)), spat_ind=1)
    leaves = jax.tree_util.tree_leaves(c)
    assert len(leaves) == 2
    s = SpatialComp(A=jnp.ones((2, 1)), mix_type="inst")
    assert jax.tree_util.tree_structure(s) != jax.tree_util.tree_structure(
        s.replace(free=False))


def test_cache_env_var_wins(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
