"""The term table: how the CUDA kernels read a covariance kernel.

A kernel that is ``cuda_supported`` is a sum of leaf terms. The CUDA Gram
and gradient kernels take it as two small device arrays: ``table`` holds one
``(type, offset)`` pair per term, and ``params`` the hyperparameters in
:func:`gpx_torch.params.leaves` order, where ``offset`` points at the term's
first one. Gradient outputs use the same indices as ``params``.

:func:`term_derivatives` is the plain version of the device functions'
``dk/dtheta`` formulas (``csrc/terms.cuh``); the tests hold it against torch
autograd of ``evaluate_r2``.
"""

from __future__ import annotations

import torch

from gpx_torch.kernels import SquaredExponential, Sum, White
from gpx_torch.params import leaves

SE, WHITE = 0, 1
MAX_TERMS = 8  # csrc/terms.cuh: GPX_MAX_TERMS


def terms(kernel) -> list[tuple[int, int, object]]:
    """``(type, offset, term)`` for each leaf term of ``kernel``."""
    parts = tuple(kernel.kernels) if isinstance(kernel, Sum) else (kernel,)
    out, off = [], 0
    for term in parts:
        if isinstance(term, SquaredExponential):
            out.append((SE, off, term))
            off += 2
        elif isinstance(term, White):
            out.append((WHITE, off, term))
            off += 1
        else:
            raise ValueError(f"no CUDA device function for {type(term).__name__}")
    if len(out) > MAX_TERMS:
        raise ValueError(f"more than {MAX_TERMS} terms")
    return out


_tables: dict[tuple, torch.Tensor] = {}


def table_tensors(kernel, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(table, params)``: int32 ``(2 T,)`` and float32 ``(P,)`` on ``device``.

    The table depends only on the kernel's structure, so it is copied to
    the device once per structure; ``params`` is gathered from the
    kernel's leaves at every call (a device op when they are on it)."""
    flat = tuple(v for typ, off, _ in terms(kernel) for v in (typ, off))
    key = (flat, torch.device(device))
    table = _tables.get(key)
    if table is None:
        table = torch.tensor(flat, dtype=torch.int32, device=device)
        _tables[key] = table
    ps = [leaf.reshape(()) for leaf in leaves(kernel)]
    if any(p.numel() != 1 for p in ps):
        raise ValueError("term-table hyperparameters must be scalars")
    params = torch.stack(ps).to(device=device, dtype=torch.float32)
    return table, params


def term_derivatives(kernel, r2) -> list[torch.Tensor]:
    """``dk/dtheta_p`` at ``r2`` for each hyperparameter, by the explicit
    formulas of the device functions: SE ``h exp(-r2/s^2)`` gives
    ``d/dh = e`` and ``d/ds = h e 2 r2 / s^3``; White ``s [r2 == 0]`` gives
    ``d/ds = [r2 == 0]``."""
    out = []
    for typ, _, term in terms(kernel):
        if typ == SE:
            s = term.sigma
            e = torch.exp(-r2 / (s * s))
            out += [e, term.h * e * 2.0 * r2 / (s * s * s)]
        else:
            out.append((r2 == 0.0).to(r2.dtype))
    return out
