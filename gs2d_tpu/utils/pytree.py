"""Frozen dataclasses that are JAX pytrees."""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """A frozen dataclass registered as a pytree whose fields are all
    children, with ``.replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names,
                                            meta_fields=[])
