"""Frozen dataclasses that are JAX pytrees.

`PyTreeNode` subclasses become frozen dataclasses registered with
`jax.tree_util.register_dataclass`: fields are pytree leaves unless
declared `field(pytree_node=False)`, which makes them static metadata
(part of the treedef, so they must be hashable and select a compiled
program).  `.replace(**updates)` returns a modified copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` marks it static."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


class PyTreeNode:
    """Base class: subclasses are frozen dataclass pytrees."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields
                         if f.metadata.get("pytree_node", True)],
            meta_fields=[f.name for f in fields
                         if not f.metadata.get("pytree_node", True)])

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)
