"""Multi-output SVGP: minibatched variational LMC over inducing points —
the port of ``gpx/models/svgp_mo.py``.

Q independent latent GPs ``g_q ~ GP(0, k_q)`` mixed linearly into T
outputs, ``f_t(x) = sum_q W[t, q] g_q(x)``, ``y_t ~ N(f_t, noise_t)``. Each
latent has its own whitened variational posterior over shared inducing
locations (:mod:`gpx_torch.models.svgp`'s design per latent), so the
per-entry expected log-likelihood stays closed-form:

    mean[b, t] = sum_q W[t, q] m_q[b],   var[b, t] = sum_q W[t, q]^2 v_q[b].

A step costs Q (M, M) factors and (M, B) solves; on the card, in float32,
every ``K_q(z, z)`` and ``K_q(z, x_b)`` comes from the CUDA Gram kernel.
:func:`train` is ``torch.optim.Adam`` in a Python loop, as
:func:`gpx_torch.models.svgp.train`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpx_torch import bijectors as bij
from gpx_torch._device import as_tensor, full_fp32, resolve_device
from gpx_torch._module import FieldModule
from gpx_torch.distributions import normal_interval
from gpx_torch.models.multioutput import _staggered_w
from gpx_torch.models.svgp import _c_factor, _jitter, _train
from gpx_torch.ops.chol import cholesky, forward_solve
from gpx_torch.ops.distance import as_locations
from gpx_torch.params import leaves


class MoSVGPParams(FieldModule):
    """Q latent kernels + (T, Q) mixing matrix."""

    _fields = ("kernels", "w")

    def __init__(self, kernels, w):
        super().__init__(kernels=tuple(kernels), w=w)

    @property
    def n_latent(self) -> int:
        return len(self.kernels)

    @property
    def n_outputs(self) -> int:
        return self.w.shape[0]

    def bijectors(self) -> "MoSVGPParams":
        return MoSVGPParams(kernels=tuple(k.bijectors() for k in self.kernels),
                            w=bij.identity)


def mo_svgp(kernels, n_outputs: int, *, w=None) -> MoSVGPParams:
    """Constructor; the default ``W`` is the staggered near-equal mix of
    ``multioutput.icm``, on the first kernel's device and in its type."""
    kernels = tuple(kernels)
    like = leaves(kernels[0])[0]
    if w is None:
        w = _staggered_w(n_outputs, len(kernels), like)
    return MoSVGPParams(kernels=kernels, w=as_tensor(
        w, device=like.device, dtype=like.dtype))


class MoSVGPState(NamedTuple):
    """Per-latent whitened variational states, stacked on axis 0."""

    mu: torch.Tensor      # (Q, M)
    c_raw: torch.Tensor   # (Q, M, M)


def init_state(q: int, m: int, dtype=torch.float32, *,
               device=None) -> MoSVGPState:
    dev = resolve_device(device)
    return MoSVGPState(mu=torch.zeros((q, m), dtype=dtype, device=dev),
                       c_raw=torch.zeros((q, m, m), dtype=dtype, device=dev))


def _latent_moments(p: MoSVGPParams, z, state: MoSVGPState, xb):
    """Per-latent predictive moments at ``xb``: ``m_q`` (Q, B) and ``v_q``
    (Q, B) under the whitened q(v_q)."""
    full_fp32()
    z = as_locations(z)
    xb = as_locations(xb)
    ms, vs = [], []
    for qi, kern in enumerate(p.kernels):
        luu = cholesky(kern.gram(z, nugget=_jitter(z.dtype)))
        a = forward_solve(luu, kern.gram(z, xb))          # (M, B)
        c = _c_factor(state.c_raw[qi])
        ms.append(a.T @ state.mu[qi])
        kff = kern.diag(xb, dtype=a.dtype)
        vs.append(kff - torch.sum(a * a, dim=0)
                  + torch.sum((c.T @ a) ** 2, dim=0))
    return torch.stack(ms), torch.stack(vs)


def kl(state: MoSVGPState):
    """sum_q KL(q(v_q) || N(0, I)), the whitened standard-normal form."""
    c = _c_factor(state.c_raw)
    q, m = state.mu.shape
    return 0.5 * (torch.sum(state.mu * state.mu) + torch.sum(c * c)
                  - 2.0 * torch.sum(torch.diagonal(state.c_raw, dim1=-2,
                                                   dim2=-1)) - q * m)


def _noise_row(noise, t: int, like):
    return torch.as_tensor(noise, dtype=like.dtype,
                           device=like.device).broadcast_to((t,))


def elbo_minibatch(p: MoSVGPParams, z, state: MoSVGPState, xb, Yb, *,
                   n_total: int, noise, mask_b=None):
    """Unbiased multi-output ELBO estimate from one minibatch of rows.

    ``Yb`` (B, T); ``noise`` scalar or (T,); ``mask_b`` (B, T) boolean drops
    missing entries from the likelihood (the N/B row scaling stays unbiased
    for a fixed mask)."""
    m_q, v_q = _latent_moments(p, z, state, xb)           # (Q, B) each
    Yb = as_tensor(Yb, device=m_q.device)
    b = Yb.shape[0]
    mean_bt = torch.einsum("tq,qb->bt", p.w, m_q)
    var_bt = torch.einsum("tq,qb->bt", p.w * p.w, v_q)
    s2 = _noise_row(noise, p.n_outputs, mean_bt)
    exp_ll = -0.5 * torch.log(2.0 * math.pi * s2)[None, :] - 0.5 * (
        (Yb - mean_bt) ** 2 + var_bt) / s2[None, :]
    if mask_b is not None:
        exp_ll = torch.where(mask_b, exp_ll, 0.0)
    return (n_total / b) * torch.sum(exp_ll) - kl(state)


class MoSVGPSummary(NamedTuple):
    x: torch.Tensor
    mean: torch.Tensor       # (M*, T)
    variance: torch.Tensor   # (M*, T)

    def interval(self, q):
        return normal_interval(self.mean, self.variance, q)


def fit(p: MoSVGPParams, z, state: MoSVGPState, xs, *,
        noise=0.0) -> MoSVGPSummary:
    """Predictive q(f*) per output (add ``noise``, scalar or (T,), for the
    observation predictive)."""
    xs = as_locations(xs)
    m_q, v_q = _latent_moments(p, z, state, xs)
    mean = torch.einsum("tq,qb->bt", p.w, m_q)
    var = torch.einsum("tq,qb->bt", p.w * p.w, v_q)
    s2 = _noise_row(noise, p.n_outputs, mean)
    return MoSVGPSummary(x=xs, mean=mean,
                         variance=torch.clamp_min(var, 0.0) + s2[None, :])


def train(key, p: MoSVGPParams, z, x, Y, *, noise, batch_size: int = 256,
          steps: int = 1000, learning_rate: float = 1e-2,
          train_inducing: bool = True, train_hyper: bool = True,
          train_noise: bool = False, mask=None):
    """Adam on the minibatch multi-output ELBO over the variational states,
    the kernels and W, the inducing locations and, optionally, the
    per-output noise (log scale), as :func:`gpx_torch.models.svgp.train`.
    ``mask`` (N, T) boolean, True = observed.

    Returns ``(params, z, state, noise, elbo_trace)``."""
    full_fp32()
    x = as_locations(x)
    z = as_locations(z)
    Y = as_tensor(Y, device=x.device)
    n_total = x.shape[0]
    if tuple(Y.shape) != (n_total, p.n_outputs):
        raise ValueError(f"Y has shape {tuple(Y.shape)}; expected "
                         f"({n_total}, {p.n_outputs})")
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=x.device)

    def elbo(pc, zz, state, idx, s2):
        return elbo_minibatch(pc, zz, state, x[idx], Y[idx], n_total=n_total,
                              noise=s2,
                              mask_b=None if mask is None else mask[idx])

    return _train(key, p, z, x,
                  init_state(p.n_latent, z.shape[0], dtype=x.dtype,
                             device=x.device),
                  _noise_row(noise, p.n_outputs, x), elbo,
                  batch_size=batch_size, steps=steps,
                  learning_rate=learning_rate, train_inducing=train_inducing,
                  train_hyper=train_hyper, train_noise=train_noise)
