"""Frozen dataclasses registered as JAX pytrees.

Array fields are pytree leaves that flow through jit/vmap/shard_map;
fields declared with static_field() are pytree METADATA: part of the tree
structure, so a change of value re-traces (and re-specializes) the
compiled program instead of becoming a traced operand.
"""
from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept as pytree metadata (hashable, static)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Freeze cls as a dataclass, register it with
    jax.tree_util.register_dataclass, and give it .replace(**changes)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (meta if f.metadata.get("static") else data).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = dataclasses.replace
    return cls
