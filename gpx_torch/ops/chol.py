"""Cholesky factorization and triangular solves on ``torch.linalg`` — the
port of ``gpx/ops/chol.py``: the non-fused route."""

from __future__ import annotations

import torch


def cholesky(a):
    """Lower Cholesky factor of an SPD matrix; NaN throughout where the
    factorization fails (a matrix that is not positive definite), as the
    JAX package's returns, instead of raising. The NaN is added, so a
    gradient through a failed factor is NaN too; no host sync."""
    l, info = torch.linalg.cholesky_ex(a)
    fail = torch.where(info != 0, float("nan"), 0.0).to(l.dtype)
    return l + fail[..., None, None]


def _solve(t, b, upper: bool):
    vec = b.ndim == 1
    out = torch.linalg.solve_triangular(t, b[:, None] if vec else b,
                                        upper=upper)
    return out[:, 0] if vec else out


def forward_solve(l, b):
    """Solve ``L x = b`` with lower-triangular ``L``; ``b`` a vector or a
    matrix of right-hand sides."""
    return _solve(l, b, upper=False)


def back_solve(u, b):
    """Solve ``U x = b`` with upper-triangular ``U``."""
    return _solve(u, b, upper=True)


def spd_inverse_from_chol(l):
    """``K^-1 = L^-T L^-1`` from the lower Cholesky factor."""
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    l_inv = torch.linalg.solve_triangular(l, eye, upper=False)
    return l_inv.T @ l_inv


def logdet_from_chol(l):
    """``log det K = 2 sum log diag(L)``."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)),
                           dim=-1)
