"""Dataclass helpers — the port of ``gpx/utils/pytree.py``.

The JAX package registers frozen dataclasses as pytrees. In the port,
kernels, means and ``Parameters`` are :class:`~gpx_torch._module.FieldModule`s
walked by :mod:`gpx_torch.params`; :func:`tree_replace` rebuilds one of
those (or a dataclass) with some fields replaced, and
:func:`pytree_dataclass` makes a frozen dataclass that
``torch.utils._pytree`` can flatten and rebuild.
"""

from __future__ import annotations

import dataclasses

import torch.utils._pytree as torch_pytree
from torch.nn import ModuleList

from gpx_torch._module import FieldModule


def pytree_dataclass(cls=None, *, meta_fields: tuple[str, ...] = ()):
    """Decorate a class as a frozen dataclass registered with
    ``torch.utils._pytree``. Fields named in ``meta_fields`` are static
    (the flatten's context); all other fields are leaves."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data = [f.name for f in dataclasses.fields(c)
                if f.name not in meta_fields]

        def flatten(obj):
            return ([getattr(obj, n) for n in data],
                    tuple(getattr(obj, n) for n in meta_fields))

        def rebuild(values, context):
            return c(**dict(zip(data, values)),
                     **dict(zip(meta_fields, context)))

        torch_pytree.register_pytree_node(
            c, flatten, rebuild,
            serialized_type_name=f"{c.__module__}.{c.__qualname__}")
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def tree_replace(obj, **changes):
    """``obj`` with the fields in ``changes`` replaced. A ``FieldModule``
    (a kernel, a mean, ``Parameters``) is rebuilt from its fields and
    static arguments as :func:`gpx_torch.params.unflatten` rebuilds one,
    the fields not named keeping their tensors and sub-modules; anything
    else goes through ``dataclasses.replace``."""
    if not isinstance(obj, FieldModule):
        return dataclasses.replace(obj, **changes)
    unknown = set(changes) - set(obj._fields)
    if unknown:
        raise TypeError(f"{type(obj).__name__} has no field(s) "
                        f"{sorted(unknown)}")
    fields = {}
    for name in obj._fields:
        value = changes[name] if name in changes else getattr(obj, name)
        fields[name] = tuple(value) if isinstance(value, ModuleList) else value
    return type(obj)(**fields, **obj._meta())
