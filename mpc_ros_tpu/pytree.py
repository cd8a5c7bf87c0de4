"""Frozen dataclasses that are JAX pytrees.

`dataclass` registers a frozen dataclass with `jax.tree_util` so it can be
passed through `jit`, `vmap` and `lax` control flow: every field is a
traced leaf unless it is declared with `field(pytree_node=False)`, which
makes it static (hashed into the treedef, never traced). `.replace(**kw)`
returns a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, pytree_node: bool = True, **kwargs):
    """`dataclasses.field`; `pytree_node=False` marks a static field."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Turn `cls` into a frozen dataclass registered as a pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
