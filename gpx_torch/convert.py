"""Weights between the JAX package and the port, through numpy.

``gpx``'s parameter leaves (``jax.tree_util.tree_leaves`` order, as numpy
arrays) and the port's :func:`gpx_torch.params.leaves` are in the same
order, so a list of arrays moves a parameter set from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from gpx_torch.params import leaves, unflatten


def params_from_numpy(template, arrays):
    """``template``'s structure with ``arrays`` as its leaves, each on the
    device and in the type of the template leaf it replaces."""
    tl = leaves(template)
    arrays = list(arrays)
    if len(arrays) != len(tl):
        raise ValueError(f"{len(arrays)} arrays for {len(tl)} leaves")
    new = []
    for t, a in zip(tl, arrays):
        a = np.array(a)  # a writable copy: JAX arrays export read-only
        if a.shape != tuple(t.shape):
            raise ValueError(f"leaf shape {a.shape} != template {tuple(t.shape)}")
        new.append(torch.as_tensor(a, dtype=t.dtype, device=t.device))
    return unflatten(template, new)


def params_to_numpy(tree) -> list[np.ndarray]:
    """The leaves of ``tree`` as numpy arrays, in the JAX flatten order."""
    return [leaf.detach().cpu().numpy() for leaf in leaves(tree)]
