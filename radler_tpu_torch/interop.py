"""Carry state from the JAX package to the port.

``radler_tpu`` objects are read by duck typing, so this module imports
nothing of JAX: a ``radler_tpu.Settings`` (or any object with the same
fields) becomes the port's :class:`~radler_tpu_torch.settings.Settings`, a
``radler_tpu`` ``CubeMeta`` the port's, and a JAX ``("chan", "tile")`` mesh
the port's :class:`~radler_tpu_torch.parallel.mesh.Mesh`.  Arrays cross as
NumPy.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from . import settings as _settings
from .image_set import CubeMeta
from .parallel.mesh import Mesh


def _convert(value):
    """A reference settings value as the port's: enums map by class and
    member name, dataclasses field by field, containers element-wise."""
    if isinstance(value, enum.Enum):
        return getattr(_settings, type(value).__name__)[value.name]
    if dataclasses.is_dataclass(value):
        cls = getattr(_settings, type(value).__name__)
        return cls(
            **{
                f.name: _convert(getattr(value, f.name))
                for f in dataclasses.fields(cls)
            }
        )
    if isinstance(value, (set, frozenset, list, tuple)):
        return type(value)(_convert(v) for v in value)
    return value


def settings_from_reference(obj) -> _settings.Settings:
    """The port's ``Settings`` with every field of ``obj``, a
    ``radler_tpu.Settings``."""
    return _convert(obj)


def cube_meta_from_reference(meta) -> CubeMeta:
    """The port's ``CubeMeta`` from a ``radler_tpu.image_set.CubeMeta``."""
    return CubeMeta(**{name: getattr(meta, name) for name in CubeMeta._fields})


def mesh_from_jax(mesh, device="cuda") -> Mesh:
    """The port's ``Mesh`` of the same ``("chan", "tile")`` shape as
    ``mesh``, a ``jax.sharding.Mesh`` (read through its ``shape``
    mapping), with every shard on ``device``."""
    shape = dict(mesh.shape)
    return Mesh(int(shape["chan"]), int(shape["tile"]), torch.device(device))
