"""Sparse GP regression with inducing points (Titsias' collapsed bound,
SGPR) — the port of ``gpx/models/sparse.py``.

The bound trains the kernel's hyperparameters and the inducing locations
by autograd; its work is (M, N) and (M, M) products. On the card, in
float32, ``Kuu`` and ``Kuf`` come from the CUDA Gram kernel
(:func:`gpx_torch.ops.gram.gram`); the factors and solves are
``torch.linalg``'s, NaN where a factor fails (as the JAX package's).

Stable formulation:
  Luu = chol(Kuu + jitter I)
  A   = Luu^-1 Kuf / sigma
  B   = I + A A^T,  LB = chol(B)
  c   = LB^-1 (A err) / sigma
  elbo = -N/2 log(2 pi sigma^2) - sum log diag(LB)
         - ||err||^2 / (2 sigma^2) + ||c||^2 / 2
         - tr(Kff) / (2 sigma^2) + tr(A A^T) / 2
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpx_torch._device import as_tensor, full_fp32
from gpx_torch.ops.chol import cholesky, forward_solve
from gpx_torch.ops.distance import as_locations
from gpx_torch.params import Parameters

JITTER = 1e-6          # float64
JITTER_F32 = 1e-4      # float32: near-duplicate inducing points make Kuu
                       # singular beyond float32 at 1e-6 (the JAX package
                       # measured a NaN factor with 64 inducing points drawn
                       # from 4096 clustered inputs)


def _jitter(dtype) -> float:
    return JITTER if torch.finfo(dtype).bits >= 64 else JITTER_F32


def _common(params: Parameters, z, x, y, noise):
    full_fp32()
    x = as_locations(x)
    z = as_locations(z)
    y = as_tensor(y, device=x.device)
    n = x.shape[0]
    m = z.shape[0]
    sigma = torch.sqrt(torch.as_tensor(noise, dtype=x.dtype, device=x.device))

    kuu = params.kernel.gram(z, nugget=_jitter(z.dtype))
    kuf = params.kernel.gram(z, x)                 # (M, N)
    luu = cholesky(kuu)
    err = y - params.mean(x)

    a = forward_solve(luu, kuf) / sigma            # (M, N)
    # full float32 (TF32 off): B is built ahead of a Cholesky
    b = torch.eye(m, dtype=a.dtype, device=a.device) + a @ a.T
    lb = cholesky(b)
    aerr = a @ err
    c = forward_solve(lb, aerr) / sigma            # (M,)
    return x, z, n, sigma, luu, lb, a, c, err


def elbo(params: Parameters, z, x, y, *, noise: float):
    """Collapsed variational lower bound on the exact logML. Equals the
    exact marginal likelihood when the inducing points cover the data
    (``z = x``); a lower bound otherwise."""
    x, z, n, sigma, luu, lb, a, c, err = _common(params, z, x, y, noise)
    kff_diag = params.kernel.diag(x, dtype=err.dtype)
    return (
        -0.5 * n * torch.log(2.0 * math.pi * sigma**2)
        - torch.sum(torch.log(torch.diagonal(lb)))
        - 0.5 * (err @ err) / sigma**2
        + 0.5 * (c @ c)
        - 0.5 * torch.sum(kff_diag) / sigma**2
        + 0.5 * torch.sum(a * a)
    )


class SparseSummary(NamedTuple):
    x: torch.Tensor
    mean: torch.Tensor
    variance: torch.Tensor


def fit(params: Parameters, z, x, y, xs, *, noise: float) -> SparseSummary:
    """Approximate posterior at test points ``xs`` (O(N M^2 + M^2 S))."""
    x, z, n, sigma, luu, lb, a, c, err = _common(params, z, x, y, noise)
    xs = as_locations(xs)
    kus = params.kernel.gram(z, xs)                # (M, S)
    tmp1 = forward_solve(luu, kus)                 # Luu^-1 Kus
    tmp2 = forward_solve(lb, tmp1)                 # LB^-1 ...
    mean = params.mean(xs) + tmp2.T @ c
    kss = params.kernel.diag(xs, dtype=mean.dtype)
    var = torch.clamp_min(
        kss - torch.sum(tmp1 * tmp1, dim=0) + torch.sum(tmp2 * tmp2, dim=0),
        0.0)
    return SparseSummary(x=xs, mean=mean, variance=var)


def init_inducing(key, x, m: int):
    """``m`` distinct data points, drawn with the ``torch.Generator``
    ``key``, as initial inducing locations."""
    x = as_locations(x)
    idx = torch.randperm(x.shape[0], generator=key, device=key.device)[:m]
    return x[idx.to(x.device)]
