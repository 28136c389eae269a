"""Conjugate Gibbs updates: plane-mean coefficients and the noise
precision — the port of ``gpx/infer/gibbs.py`` (the reference's
``MeanParameters.samplePlane``, MeanParameters.scala:74-103, and
``KernelParameters.samplePrecY``, KernelParameters.scala:209-222).

The JAX package's fixes of the reference stay: the full conditional's mean
uses ``X^T K^-1 y`` and its draw the root ``chol(prec)^-T z``, and the
Gamma update is on the rate. Draws take a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from gpx_torch._device import full_fp32
from gpx_torch.distributions import Gamma, Normal
from gpx_torch.means import Plane, design_matrix
from gpx_torch.ops.chol import back_solve, cholesky, forward_solve
from gpx_torch.ops.distance import as_locations
from gpx_torch.params import Parameters


def sample_plane(generator, prior: Normal, x, y, params: Parameters, *,
                 nugget=1e-6):
    """Draw plane-mean coefficients from their GLS full conditional,
    ``beta | y ~ N(A^-1 b, A^-1)`` with ``A = X^T K^-1 X + P0`` and ``b =
    P0 m0 + X^T K^-1 y``, where ``P0 = I / prior.scale^2`` and ``m0 =
    prior.loc`` (the reference's iid Gaussian prior). The products run in
    full float32 (TF32 off), where the JAX package asks for HIGHEST: the
    precision is factored next."""
    full_fp32()
    x = as_locations(x)
    xd = design_matrix(x)
    q = xd.shape[-1]
    l = cholesky(params.kernel.gram(x, nugget=nugget))
    w = forward_solve(l, xd)       # L^-1 X
    u = forward_solve(l, y)        # L^-1 y
    eye = torch.eye(q, dtype=l.dtype, device=l.device)
    prior_prec = eye / (prior.scale ** 2)
    prec = w.T @ w + prior_prec    # X^T K^-1 X + P0
    b = prior_prec @ (prior.loc * torch.ones(q, dtype=l.dtype,
                                             device=l.device)) + w.T @ u
    l_prec = cholesky(prec)
    mean = back_solve(l_prec.T, forward_solve(l_prec, b))
    z = torch.randn(q, generator=generator, dtype=l.dtype, device=l.device)
    return Plane(beta=mean + back_solve(l_prec.T, z))  # cov = prec^-1


def sample_mean(generator, prior: Normal, x, y, params: Parameters, *,
                nugget=1e-6):
    """MeanParameters.sample (MeanParameters.scala:111-121): a Plane mean
    gets the conjugate draw, a Zero mean passes through."""
    if isinstance(params.mean, Plane):
        return Parameters(mean=sample_plane(generator, prior, x, y, params,
                                            nugget=nugget),
                          kernel=params.kernel)
    return params


def sample_precision_y(generator, prior: Gamma, y, fx):
    """Conjugate draw of the observation noise precision given latent
    function values (KernelParameters.samplePrecY, with the rate fix):
    ``(draw, posterior)``."""
    ssy = torch.sum((y - fx) ** 2)
    posterior = Gamma(concentration=prior.concentration + 0.5 * y.shape[-1],
                      rate=prior.rate + 0.5 * ssy)
    return posterior.sample(generator), posterior
