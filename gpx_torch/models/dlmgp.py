"""Spatio-temporal DLM + GP joint model — the port of
``gpx/models/dlmgp.py`` (the reference's DLM-GP layer): a DLM carries the
time dynamics of a latent state shared across sensors, and a GP over the
sensor locations models the spatial structure of the observation
residuals; its covariance ``K(x, x)`` is the DLM's observation noise
(``v = Kxx``).

A Gibbs sweep is a Kalman filter and FFBS draw with ``v = Kxx``, a
random-walk MH move on the kernel's unconstrained hyperparameters given
the residuals, and a conjugate W draw. The GP likelihood of the T
per-time residual vectors is one Cholesky and one multi-right-hand-side
triangular solve. On float32 card tensors every ``Kxx`` comes from the
CUDA Gram kernel: one for the sweep's filter and one for each of the MH
step's two log-posteriors. Also completes the reference's
``DlmGp.simStep`` (:func:`simulate`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpx_torch import params as gparams
from gpx_torch._device import as_tensor, full_fp32, generators
from gpx_torch.distributions import InverseGamma
from gpx_torch.models import dlm as dlm_mod
from gpx_torch.models import gp
from gpx_torch.ops import chol
from gpx_torch.ops.distance import as_locations
from gpx_torch.params import Parameters


def grid_locations(x_range, y_range, nx: int, ny: int, *, device=None,
                   dtype=None):
    """Regular 2-D grid of locations, ``(nx * ny, 2)``, the first
    coordinate slowest; on ``device`` (default: the card)."""
    xs = torch.linspace(x_range[0], x_range[1], nx, dtype=torch.float64)
    ys = torch.linspace(y_range[0], y_range[1], ny, dtype=torch.float64)
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    return as_tensor(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1),
                     device=device, dtype=dtype or torch.get_default_dtype())


def replicated_log_marginal_likelihood(params: Parameters, x, resids, *,
                                       nugget: float = gp.LOGML_NUGGET):
    """GP marginal log-likelihood of T iid spatial replicates, ``resids``
    (T, N) (rows are replicates over the N locations): one Cholesky and
    one multi-right-hand-side triangular solve."""
    full_fp32()
    x = as_locations(x)
    n = x.shape[0]
    t = resids.shape[0]
    l = chol.cholesky(params.kernel.gram(x, nugget=nugget))
    centered = resids - params.mean(x)[None, :]
    u = chol.forward_solve(l, centered.T)        # (N, T)
    half_logdet = torch.sum(torch.log(torch.diagonal(l)))
    return (-0.5 * torch.sum(u * u) - t * half_logdet
            - 0.5 * t * n * math.log(2.0 * math.pi))


def simulate(key, model: dlm_mod.DLM, params: Parameters, x_locations,
             v_extra, w, m0, n_steps: int):
    """Simulate the joint DLM-GP: states evolve by G with noise W, and the
    observations add a GP draw over the sensor locations and iid noise of
    variance ``v_extra``. ``key`` is a ``torch.Generator``: three blocks
    of standard normals, (n_steps, d_state), (n_steps, N) and (n_steps,
    d_obs). Returns ``(states, ys)``."""
    full_fp32()
    x_locations = as_locations(x_locations)
    like = dict(dtype=x_locations.dtype, device=x_locations.device)
    l_k = chol.cholesky(params.kernel.gram(x_locations,
                                           nugget=gp.DRAW_NUGGET))
    d_state = model.g.shape[0]
    w = as_tensor(w, **like)
    w_chol = torch.diag(torch.sqrt(w)) if w.ndim == 1 else chol.cholesky(w)

    def normal(size):
        return torch.randn(size, generator=key, dtype=like["dtype"],
                           device=key.device).to(like["device"])

    z_state = normal((n_steps, d_state))
    z_gp = normal((n_steps, x_locations.shape[0]))
    z_obs = normal((n_steps, model.f.shape[0]))
    x_state, states = as_tensor(m0, **like), []
    for t in range(n_steps):
        x_state = model.g @ x_state + w_chol @ z_state[t]
        states.append(x_state)
    states = torch.stack(states)
    ys = (states @ model.f.T + z_gp @ l_k.T
          + torch.sqrt(as_tensor(v_extra, **like)) * z_obs)
    return states, ys


class DlmGpResult(NamedTuple):
    kernel_flat: torch.Tensor   # (iters, n_kernel_params) constrained draws
    w: torch.Tensor             # (iters, d_state)
    states: torch.Tensor        # (iters, T, d_state)
    accept_rate: torch.Tensor


def gibbs_sample(key, model: dlm_mod.DLM, ys, x_locations,
                 template: Parameters, log_prior_kernel,
                 prior_w: InverseGamma, m0, c0, n_iters: int, *,
                 proposal_scale: float = 0.1, w0=None,
                 nugget: float = gp.LOGML_NUGGET) -> DlmGpResult:
    """Joint Gibbs: per sweep, (1) a Kalman filter and FFBS state draw with
    the GP Gram as the DLM's observation covariance (``v = Kxx``); (2) a
    random-walk MH move on the kernel's unconstrained hyperparameters
    given the residuals (a NaN log-posterior at the proposal rejects it);
    (3) a conjugate W draw. ``key``: an int seed or a ``torch.Generator``;
    sweep i draws (the FFBS normals, the proposal, the uniform, the W
    gammas) from the i-th of ``n_iters`` generators seeded from it."""
    x_locations = as_locations(x_locations)
    ys = as_tensor(ys, device=x_locations.device)
    like = dict(dtype=ys.dtype, device=ys.device)
    d_state = model.g.shape[0]
    w = (torch.ones(d_state, **like) * 0.1 if w0 is None
         else as_tensor(w0, **like))

    bij_k = template.kernel.bijectors()
    u_flat, unravel_k = gparams.unraveler(
        gparams.unconstrain(bij_k, template.kernel))

    def kernel_of(u):
        return gparams.constrain(bij_k, unravel_k(u))

    def kernel_logpost(u, resids):
        kern = kernel_of(u)
        p = Parameters(mean=template.mean, kernel=kern)
        return (log_prior_kernel(kern)
                + replicated_log_marginal_likelihood(p, x_locations, resids,
                                                     nugget=nugget)
                + gparams.log_det_jacobian(bij_k, unravel_k(u)))

    accepted = torch.zeros((), dtype=torch.int64, device=ys.device)
    kflat, ws, states = [], [], []
    for gen in generators(key, n_iters, ys.device):
        kxx = kernel_of(u_flat).gram(x_locations, nugget=nugget)
        filtered = dlm_mod.kalman_filter(model, ys, kxx, w, m0, c0)
        xs = dlm_mod.ffbs(gen, model, filtered, w)
        resids = ys - xs @ model.f.T

        step = torch.randn(u_flat.shape, generator=gen, dtype=u_flat.dtype,
                           device=gen.device).to(u_flat.device)
        prop = u_flat + proposal_scale * step
        lp_cur = kernel_logpost(u_flat, resids)
        lp_prop = kernel_logpost(prop, resids)
        lp_prop = torch.where(torch.isnan(lp_prop), -math.inf, lp_prop)
        uniform = torch.rand((), generator=gen, dtype=u_flat.dtype,
                             device=gen.device).to(u_flat.device)
        accept = torch.log(uniform) < (lp_prop - lp_cur)
        u_flat = torch.where(accept, prop, u_flat)
        w = dlm_mod.sample_system_variance(gen, prior_w, model, xs)
        accepted = accepted + accept.to(torch.int64)
        kflat.append(gparams.to_array(kernel_of(u_flat)))
        ws.append(w)
        states.append(xs)
    return DlmGpResult(kernel_flat=torch.stack(kflat), w=torch.stack(ws),
                       states=torch.stack(states),
                       accept_rate=accepted.to(ys.dtype) / n_iters)
