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


def eigh(a):
    """``(eigenvalues, eigenvectors)`` of a symmetric matrix; NaN throughout
    where the algorithm fails (a matrix with non-finite entries), as the
    JAX package's returns, instead of raising. The NaN is built from ``a``,
    so a gradient through a failed decomposition is NaN too."""
    try:
        return torch.linalg.eigh(a)
    except torch.linalg.LinAlgError:
        nan = a * float("nan")
        return torch.diagonal(nan, dim1=-2, dim2=-1), nan


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


def cho_solve(l, b):
    """Solve ``(L L^T) x = b`` from the lower Cholesky factor, without
    forming ``K^-1``."""
    return back_solve(l.mT, forward_solve(l, b))


def tri_inverse_lower(l, base: int = 256):
    """Explicit inverse of a lower-triangular matrix by blocked
    divide-and-conquer, ``inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 B
    A^-1, C^-1]]``, with leaves of at most ``base`` rows solved against an
    identity; the split is the JAX package's (a multiple of 128 from n =
    257 on)."""
    n = l.shape[-1]
    if n <= base:
        eye = torch.eye(n, dtype=l.dtype, device=l.device)
        return torch.linalg.solve_triangular(l, eye, upper=False)
    m = max(128, ((n // 2) // 128) * 128) if n > 256 else n // 2
    a_inv = tri_inverse_lower(l[..., :m, :m], base)
    c_inv = tri_inverse_lower(l[..., m:, m:], base)
    out = torch.zeros_like(l)
    out[..., :m, :m] = a_inv
    out[..., m:, :m] = -(c_inv @ (l[..., m:, :m] @ a_inv))
    out[..., m:, m:] = c_inv
    return out


def spd_inverse_from_chol(l, base: int | None = None):
    """``K^-1 = L^-T L^-1`` from the lower Cholesky factor. ``base=None``
    solves ``L`` against the identity in one call (``torch.linalg`` has no
    large temporaries there, which the JAX package's recursion avoids on
    the TPU); an int takes :func:`tri_inverse_lower` with leaves of that
    size, as the JAX package does (its default, 256)."""
    if base is None:
        eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
        l_inv = torch.linalg.solve_triangular(l, eye, upper=False)
    else:
        l_inv = tri_inverse_lower(l, base)
    return l_inv.mT @ l_inv


def logdet_from_chol(l):
    """``log det K = 2 sum log diag(L)``."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)),
                           dim=-1)


def add_jitter(a, jitter):
    """``a + jitter I``: the reference's nugget discipline (1e-3,
    GaussianProcess.scala:71,117; 1e-6, Predict.scala:67)."""
    return a + jitter * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
