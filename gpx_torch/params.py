"""Parameter containers and flattening — the port of ``gpx/params.py``.

:func:`leaves` and :func:`unflatten` walk the ``_fields`` of kernels, means
and :class:`Parameters` in the order ``jax.tree_util.tree_flatten`` gives for
the JAX package's pytrees (``Parameters`` -> mean then kernel; ``Sum`` ->
children in order; SE -> ``h``, ``sigma``; White -> ``sigma``), so a flat
list of leaves means the same thing on both sides.
"""

from __future__ import annotations

import torch

from gpx_torch._module import FieldModule


class Parameters(FieldModule):
    """A GP model's full parameter set: mean function + kernel."""

    _fields = ("mean", "kernel")

    def __init__(self, mean, kernel):
        super().__init__(mean=mean, kernel=kernel)


def _children(tree):
    for name in tree._fields:
        yield name, getattr(tree, name)


def _walk(tree, path, out):
    if isinstance(tree, torch.Tensor):
        out.append((path, tree))
        return
    for name, value in _children(tree):
        if isinstance(value, torch.nn.ModuleList):
            for i, child in enumerate(value):
                _walk(child, f"{path}.{name}[{i}]", out)
        else:
            _walk(value, f"{path}.{name}", out)


def leaves(tree) -> list[torch.Tensor]:
    """The hyperparameter tensors of ``tree``, in the JAX flatten order."""
    out = []
    _walk(tree, "", out)
    return [leaf for _, leaf in out]


def unflatten(template, new_leaves):
    """A tree with ``template``'s structure and ``new_leaves`` (in
    :func:`leaves` order) as its tensors."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        fields = {}
        for name, value in _children(node):
            if isinstance(value, torch.nn.ModuleList):
                fields[name] = tuple(build(c) for c in value)
            else:
                fields[name] = build(value)
        return type(node)(**fields, **node._meta())

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def to_array(tree) -> torch.Tensor:
    """Flatten a parameter tree to a 1-D tensor."""
    return torch.cat([leaf.reshape(-1) for leaf in leaves(tree)])


def from_array(template, flat):
    """Rebuild ``template``'s structure from a flat tensor."""
    out, i = [], 0
    for leaf in leaves(template):
        out.append(flat[i : i + leaf.numel()].reshape(leaf.shape))
        i += leaf.numel()
    if i != flat.shape[0]:
        raise ValueError(f"flat array has {flat.shape[0]} values, tree {i}")
    return unflatten(template, out)


def names(tree) -> list[str]:
    """Flat parameter names from field paths, one per scalar element —
    the same strings as the JAX package's ``gpx.params.names``."""
    out = []
    paths = []
    _walk(tree, "", paths)
    for path, leaf in paths:
        base = path.lstrip(".").replace("[", "").replace("]", "")
        n = leaf.numel()
        if n == 1:
            out.append(base)
        else:
            out.extend(f"{base}_{i}" for i in range(n))
    return out
