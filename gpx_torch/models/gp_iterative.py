"""Iterative and low-rank pieces of ``gpx/models/gp_iterative.py`` — for now
only what the hybrid gradient needs: :func:`pivoted_cholesky`, the basis of
its deflation (:func:`gpx_torch.models.gp._hybrid_deflation`)."""

from __future__ import annotations

import torch

from gpx_torch._device import full_fp32
from gpx_torch.kernels import has_white
from gpx_torch.ops.distance import as_locations, sq_distances
from gpx_torch.params import leaves


def pivoted_cholesky(kernel, x, rank: int):
    """Rank-``rank`` pivoted (greedy) Cholesky of the kernel's Gram:
    ``K ~= L_r L_r^T`` from ``rank`` adaptively chosen kernel columns, in
    O(N rank^2) time and O(N rank) memory; K never forms.

    Each step pivots on the largest residual diagonal entry, evaluates that
    kernel column (with an exact-zero self-distance at the pivot, so White
    terms count there), and subtracts the columns so far. Once the residual
    diagonal is below ``1e-7 max(diag)`` the remaining columns are zero.
    The pivot stays on the device: no step waits on the host."""
    full_fp32()
    x = as_locations(x)
    n = x.shape[0]
    dtype = x.dtype
    for leaf in leaves(kernel):
        dtype = torch.promote_types(dtype, leaf.dtype)
    diag = kernel.diag(x, dtype=dtype)
    exact = x.shape[-1] > 8 and has_white(kernel)
    floor = 1e-7 * torch.max(diag)

    l_r = torch.zeros((n, rank), dtype=dtype, device=x.device)
    d = diag.clone()
    for i in range(rank):
        pivot = torch.argmax(d).reshape(1)
        xp = x.index_select(0, pivot)                         # (1, D)
        r2 = sq_distances(x, xp, exact=exact).index_fill(0, pivot, 0.0)
        # evaluate_xx, not evaluate_r2: non-stationary kernels need the
        # coordinates
        k_col = kernel.evaluate_xx(x, xp, r2)[:, 0]
        resid = k_col - l_r @ l_r.index_select(0, pivot)[0]
        d_pivot = d.index_select(0, pivot)[0]
        # a zero column once the pivots are exhausted (dividing by a
        # cancelled-to-zero residual gives inf or NaN in float32)
        col = torch.where(d_pivot > floor,
                          resid / torch.sqrt(torch.clamp_min(d_pivot, floor)),
                          torch.zeros_like(resid))
        l_r[:, i] = col
        d = torch.clamp_min(d - col * col, 0.0).index_fill(0, pivot, 0.0)
    return l_r
