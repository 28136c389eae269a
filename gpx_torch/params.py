"""Parameter containers and flattening — the port of ``gpx/params.py``.

:func:`leaves` and :func:`unflatten` walk the ``_fields`` of kernels, means
and :class:`Parameters` in the order ``jax.tree_util.tree_flatten`` gives for
the JAX package's pytrees (``Parameters`` -> mean then kernel; ``Sum`` ->
children in order; SE -> ``h``, ``sigma``; White -> ``sigma``), so a flat
list of leaves means the same thing on both sides. A bijector tree
(``bijectors()``: the same classes with a bijector in each leaf slot) is
walked the same way, so :func:`constrain` and :func:`unconstrain` pair
its bijectors with a parameter tree's tensors leaf by leaf.
"""

from __future__ import annotations

import torch

from gpx_torch._module import FieldModule


class Parameters(FieldModule):
    """A GP model's full parameter set: mean function + kernel."""

    _fields = ("mean", "kernel")

    def __init__(self, mean, kernel):
        super().__init__(mean=mean, kernel=kernel)

    def bijectors(self) -> "Parameters":
        return Parameters(mean=self.mean.bijectors(),
                          kernel=self.kernel.bijectors())


def _children(tree):
    for name in tree._fields:
        yield name, getattr(tree, name)


def _walk(tree, path, out):
    if not isinstance(tree, FieldModule):  # a tensor, or a bijector
        out.append((path, tree))
        return
    for name, value in _children(tree):
        if isinstance(value, torch.nn.ModuleList):
            for i, child in enumerate(value):
                _walk(child, f"{path}.{name}[{i}]", out)
        else:
            _walk(value, f"{path}.{name}", out)


def leaves(tree) -> list:
    """The hyperparameter tensors of ``tree`` (the bijectors of a bijector
    tree), in the JAX flatten order."""
    out = []
    _walk(tree, "", out)
    return [leaf for _, leaf in out]


def unflatten(template, new_leaves):
    """A tree with ``template``'s structure and ``new_leaves`` (in
    :func:`leaves` order) as its tensors."""
    it = iter(new_leaves)

    def build(node):
        if not isinstance(node, FieldModule):
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


def unraveler(template):
    """``(flat0, unravel)``: ``template`` as a flat tensor and the map from
    such a tensor back to its structure."""
    return to_array(template), lambda flat: from_array(template, flat)


def constrain(bij_tree, u_tree):
    """Map an unconstrained tree to the constrained domain, leaf by leaf."""
    return unflatten(u_tree, [b.forward(u) for b, u in
                              zip(leaves(bij_tree), leaves(u_tree))])


def unconstrain(bij_tree, c_tree):
    """Inverse of :func:`constrain`."""
    return unflatten(c_tree, [b.inverse(c) for b, c in
                              zip(leaves(bij_tree), leaves(c_tree))])


def log_det_jacobian(bij_tree, u_tree):
    """Total ``log |d constrain(u) / du|``: the change-of-variables term a
    sampler on the unconstrained space adds to the log-posterior."""
    u_leaves = leaves(u_tree)
    total = torch.zeros((), dtype=u_leaves[0].dtype, device=u_leaves[0].device)
    for b, u in zip(leaves(bij_tree), u_leaves):
        total = total + torch.sum(b.log_det_jacobian(u))
    return total


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


def to_dict(tree) -> dict:
    """Name -> value, one entry per scalar (diagnostics, CSV headers)."""
    return dict(zip(names(tree), [float(v) for v in to_array(tree)]))
