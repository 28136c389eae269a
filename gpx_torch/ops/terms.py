"""The term table: how the CUDA kernels read a covariance kernel.

A kernel that is ``cuda_supported`` is a tree of sums and products over
leaf terms. The table holds its expansion into a sum of products of
leaves: every ``Product`` distributed over its ``Sum``s, recursively, each
product keeping its factors left to right (``(A + B) * C`` becomes ``A C +
B C``). The CUDA Gram, matvec and gradient kernels take it as two small
device arrays of up to :data:`~gpx_torch.kernels.MAX_TERMS` rows, and
each sizes its shared memory from them at launch: ``table`` holds one
``(type, offset, aux, group)`` row per factor, and ``params`` the
hyperparameters in
:func:`gpx_torch.params.leaves` order, unexpanded, where ``offset`` points
at the factor's leaf's first one (a leaf that appears in several products
repeats its offset); ``aux`` is Matérn's ``p`` for ``nu = p + 1/2`` (0 for
the other families) and ``group`` numbers the product the factor belongs
to. The device value is ``sum_g prod_{t in g} k_t(r2)``. Gradient outputs
use the same indices as ``params``: a repeated leaf's per-product
derivatives add into its one entry.

The expansion rounds differently from the tree (float32 ``A C + B C`` in
place of ``(A + B) C``) but cancels nothing: every family's value is >= 0,
so each product and each sum of them is a sum of non-negative terms, and
the expansion's rounding stays within a few f32 ulps of ``|K|``, the
envelope every Gram entry is held to.

:func:`term_values`, :func:`term_derivatives` and :func:`term_dr2` are the
plain versions of the device functions' ``K``, ``dK/dtheta`` and
``dK/dr2`` (``csrc/terms.cuh``); the tests hold them against torch
autograd of ``evaluate_r2``.
"""

from __future__ import annotations

import math

import torch

from gpx_torch.kernels import (
    Matern, Periodic, Product, RationalQuadratic, SquaredExponential, Sum,
    White, check_table,
)
from gpx_torch.params import leaves

SE, WHITE, MATERN, RQ, PERIODIC = 0, 1, 2, 3, 4
COLS = 4  # csrc/terms.cuh: GPX_TABLE_COLS
_FAMILIES = ((SquaredExponential, SE, 2), (White, WHITE, 1), (Matern, MATERN, 2),
             (RationalQuadratic, RQ, 3), (Periodic, PERIODIC, 3))


def _products(kernel, off: int = 0):
    """``(products, next offset)``: ``kernel`` expanded into a list of
    products, each a tuple of ``(leaf, offset)`` factors, the offsets those
    of the leaves in :func:`leaves` order from ``off``."""
    if isinstance(kernel, Sum):
        out = []
        for k in kernel.kernels:
            part, off = _products(k, off)
            out += part
        return out, off
    if isinstance(kernel, Product):
        out = [()]
        for k in kernel.kernels:
            part, off = _products(k, off)
            out = [a + b for a in out for b in part]
        return out, off
    _, arity = _family(kernel)
    return [((kernel, off),)], off + arity


def _family(term) -> tuple[int, int]:
    for cls, typ, arity in _FAMILIES:
        if type(term) is cls and term.cuda_supported:
            return typ, arity
    raise ValueError(f"no CUDA device function for {type(term).__name__}")


def terms(kernel) -> list[tuple[int, int, object]]:
    """``(type, offset, term)`` for each leaf term of ``kernel``."""
    return [(typ, off, term) for typ, off, _, _, term in _rows(kernel)]


def _rows(kernel):
    """``(type, offset, aux, group, leaf)`` per factor of the expansion."""
    check_table(kernel)
    out = []
    for g, product in enumerate(_products(kernel)[0]):
        for term, off in product:
            typ, _ = _family(term)
            aux = term._half_integer_p if typ == MATERN else 0
            out.append((typ, off, aux, g, term))
    return out


_tables: dict[tuple, torch.Tensor] = {}


def table_tensors(kernel, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(table, params)``: int32 ``(4 T,)`` and float32 ``(P,)`` on
    ``device``.

    The table depends only on the kernel's structure, so it is copied to
    the device once per structure; ``params`` is gathered from the
    kernel's leaves at every call (a device op when they are on it)."""
    flat = tuple(v for row in _rows(kernel) for v in row[:COLS])
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


def _matern_polys(p: int, s):
    """``(P_{p-1}(s), P_p(s))`` with ``k(s) = P_p(s) e^-s`` for ``nu = p +
    1/2``: ``P_0 = 1``, ``P_1 = 1 + s``, ``P_k = P_{k-1} + s^2 P_{k-2} /
    ((2k-1)(2k-3))`` (all terms positive; ``P_{-1}`` is returned as 0)."""
    if p == 0:
        return torch.zeros_like(s), torch.ones_like(s)
    a, b = torch.ones_like(s), 1.0 + s
    for k in range(2, p + 1):
        a, b = b, b + (s * s) * a / ((2 * k - 1) * (2 * k - 3))
    return a, b


def _leaf(typ, term, r2):
    """``(k, [dk/dtheta], dk/dr2)`` of one leaf, by the device functions'
    formulas. ``dk/dr2`` is 0 at ``r2 == 0`` for the families that take
    ``d = sqrt(r2)`` (Matérn, Periodic), as the JAX package's safe
    distance pins it."""
    zero = r2 == 0.0
    if typ == SE:
        s = term.sigma
        e = torch.exp(-r2 / (s * s))
        v = term.h * e
        return v, [e, term.h * e * 2.0 * r2 / (s * s * s)], -v / (s * s)
    if typ == WHITE:
        ind = zero.to(r2.dtype)
        return term.sigma * ind, [ind], torch.zeros_like(r2)
    d = torch.sqrt(r2)
    if typ == MATERN:
        p, l = term._half_integer_p, term.l
        c = math.sqrt(2 * p + 1)
        s = c * d / l
        e = torch.exp(-s)
        pm1, pp = _matern_polys(p, s)
        v = term.sigma * pp * e
        if p == 0:
            dl = term.sigma * s * e / l
            kp = -term.sigma * e / (2.0 * l * torch.where(zero, 1.0, d))
        else:
            q = term.sigma * pm1 * e / (2 * p - 1)
            dl, kp = q * s * s / l, -q * (c * c) / (2.0 * l * l)
        return v, [pp * e, dl], torch.where(zero, 0.0, kp)
    if typ == RQ:
        h, a, l = term.h, term.alpha, term.l
        z = r2 / (2.0 * a * l * l)
        q = 1.0 + z
        e = torch.exp(-a * torch.log1p(z))
        v = h * e
        return (v, [e, v * (z / q - torch.log1p(z)), v * 2.0 * a * z / (l * q)],
                -v / (2.0 * l * l * q))
    h, per, l = term.h, term.period, term.l
    x = d / per
    sn, cs = torch.sin(math.pi * x), torch.cos(math.pi * x)
    e = torch.exp(-2.0 * (sn * sn) / (l * l))
    v = h * e
    dper = v * 4.0 * math.pi * sn * cs * x / (l * l * per)
    kp = -v * 2.0 * math.pi * sn * cs / (l * l * per * torch.where(zero, 1.0, d))
    return v, [e, dper, v * 4.0 * (sn * sn) / (l * l * l)], torch.where(zero, 0.0, kp)


def _expand(kernel, r2):
    """Per product, per factor: ``(offset, (k, [dk/dtheta], dk/dr2))``."""
    out: dict[int, list] = {}
    for typ, off, _, g, term in _rows(kernel):
        out.setdefault(g, []).append((off, _leaf(typ, term, r2)))
    return list(out.values())


def _others(vals, t):
    """The product of every factor of a group but the ``t``-th, formed from
    the others (not by division: a White factor is exactly 0 off the
    diagonal)."""
    out = None
    for s, v in enumerate(vals):
        if s != t:
            out = v if out is None else out * v
    return 1.0 if out is None else out


def term_values(kernel, r2) -> torch.Tensor:
    """``K(r2) = sum_g prod_{t in g} k_t(r2)``, each product left to right
    and the products added in table order, as the device functions form
    it."""
    out = torch.zeros_like(r2)
    for group in _expand(kernel, r2):
        prod = None
        for _, (v, _, _) in group:
            prod = v if prod is None else prod * v
        out = out + prod
    return out


def term_derivatives(kernel, r2) -> list[torch.Tensor]:
    """``dK/dtheta_p`` at ``r2`` for each hyperparameter (in leaves order),
    by the explicit formulas of the device functions and the product rule;
    a leaf in several products sums its products' terms in table order.
    SE ``h exp(-r2/s^2)`` gives ``d/dh = e`` and ``d/ds = h e 2 r2 / s^3``;
    White ``s [r2 == 0]`` gives ``d/ds = [r2 == 0]``; Matérn, RQ and
    Periodic as in :func:`_leaf`."""
    out = [None] * len(leaves(kernel))
    for group in _expand(kernel, r2):
        vals = [v for _, (v, _, _) in group]
        for t, (off, (_, grads, _)) in enumerate(group):
            o = _others(vals, t)
            for q, g in enumerate(grads):
                out[off + q] = g * o if out[off + q] is None else out[off + q] + g * o
    return out


def term_dr2(kernel, r2, *, absolute: bool = False) -> torch.Tensor:
    """``dK/dr2`` at ``r2``: ``sum_g sum_{t in g} k_t'(r2) prod_{s != t}
    k_s(r2)``, 0 where ``r2 == 0`` for Matérn and Periodic leaves (the ARD
    leg multiplies it by squared coordinate differences, which vanish
    there). ``absolute``: the sum of the terms' magnitudes instead."""
    out = torch.zeros_like(r2)
    for group in _expand(kernel, r2):
        vals = [v for _, (v, _, _) in group]
        for t, (_, (_, _, kp)) in enumerate(group):
            term = kp * _others(vals, t)
            out = out + (term.abs() if absolute else term)
    return out
