"""Frozen dataclasses that are JAX pytrees.

`@struct.dataclass` makes a frozen dataclass and registers it with
`jax.tree_util.register_dataclass`; a field declared with
`struct.field(pytree_node=False, ...)` is static metadata (part of the
treedef, so a change of value retraces a jitted function), every other field
is a child.  `replace(**changes)` returns a copy with fields replaced.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    return dataclasses.field(metadata={"static": not pytree_node}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (meta if f.metadata.get("static") else data).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
