"""Dynamic linear models: Kalman filtering, FFBS, Gibbs, forecasting — the
port of ``gpx/models/dlm.py`` (the reference reaches this machinery
through the external ``bayesian_dlms`` library: model constructors and
``|+|`` composition, FFBS state sampling, Gibbs V / W updates, Kalman
forecasting).

Model: ``y_t = F x_t + v_t``, ``v_t ~ N(0, V)``; ``x_t = G x_{t-1} +
w_t``, ``w_t ~ N(0, W)``; ``x_0 ~ N(m0, C0)``, with ``F: (d_obs,
d_state)`` constant. Missing observations are NaN and skipped in the
update.

Each of the JAX package's scans over time is a Python loop over time here,
on the tensors' device (the card unless the caller passes CPU tensors),
with the matrix products in full float32 on the card. A step reads nothing
back to the host: the Cholesky jitter ladder chooses its rung on the
device (:func:`_chol_psd`). Draws take a ``torch.Generator`` where the JAX
package takes a key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpx_torch._device import as_tensor, full_fp32, generators
from gpx_torch.distributions import InverseGamma, _standard_gamma
from gpx_torch.ops import chol


class DLM:
    """Model matrices: ``f`` (d_obs, d_state) observation, ``g`` (d_state,
    d_state) evolution."""

    def __init__(self, f, g):
        self.f, self.g = f, g

    def __add__(self, other: "DLM") -> "DLM":
        """Block composition (``bayesian_dlms``' ``|+|``): observation rows
        are summed contributions, so compose only same-d_obs
        components."""
        return DLM(f=torch.cat([self.f, other.f], dim=1),
                   g=torch.block_diag(self.g, other.g))


def polynomial(order: int, *, device=None, dtype=None) -> DLM:
    """Polynomial trend DLM (order 1 = local level), on ``device``
    (default: the card)."""
    dtype = dtype or torch.get_default_dtype()
    g = torch.eye(order) + torch.diag(torch.ones(order - 1), 1)
    f = torch.zeros((1, order))
    f[0, 0] = 1.0
    return DLM(f=as_tensor(f, device=device, dtype=dtype),
               g=as_tensor(g, device=device, dtype=dtype))


def seasonal(period: int, harmonics: int, *, device=None, dtype=None) -> DLM:
    """Fourier-form seasonal DLM with ``harmonics`` harmonic pairs."""
    blocks = []
    for h in range(1, harmonics + 1):
        w = 2.0 * math.pi * h / period
        c, s = math.cos(w), math.sin(w)
        blocks.append(torch.tensor([[c, s], [-s, c]], dtype=torch.float64))
    f = torch.tensor([[1.0, 0.0] * harmonics], dtype=torch.float64)
    dtype = dtype or torch.get_default_dtype()
    return DLM(f=as_tensor(f, device=device, dtype=dtype),
               g=as_tensor(torch.block_diag(*blocks), device=device,
                           dtype=dtype))


def replicate_observations(model: DLM, n: int) -> DLM:
    """Share one latent state across ``n`` sensors: ``F`` becomes ``n``
    identical observation rows."""
    return DLM(f=model.f.repeat(n, 1), g=model.g)


class FilterResult(NamedTuple):
    """Per-time filtering output, stacked over the leading time axis."""

    m: torch.Tensor        # (T, d_state) posterior state means
    c: torch.Tensor        # (T, d_state, d_state) posterior state covs
    a: torch.Tensor        # (T, d_state) one-step-ahead state means
    r: torch.Tensor        # (T, d_state, d_state) one-step-ahead state covs
    log_likelihood: torch.Tensor


def _sym(m):
    return 0.5 * (m + m.mT)


def _chol_psd(m):
    """Cholesky of a nearly PSD matrix with an escalating scale-relative
    jitter ladder (1e-6, 1e-3, 1 of the mean diagonal in float32; 1e-12,
    1e-9, 1e-6 in float64): DLM covariances collapse toward singular as
    Gibbs sweeps shrink V and W, and float32 rounding of the Joseph
    sandwiches can leave tiny negative eigenvalues. Every rung is
    factored and the first finite one chosen on the device: no host read,
    no exception."""
    m = _sym(m)
    d = m.shape[-1]
    eps0 = 1e-6 if m.dtype == torch.float32 else 1e-12
    scale = torch.trace(m) / d + 1e-30
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    l = chol.cholesky(m + (eps0 * scale) * eye)
    for mult in (1e3, 1e6):
        ok = torch.all(torch.isfinite(torch.diagonal(l, dim1=-2, dim2=-1)))
        retry = chol.cholesky(m + (eps0 * mult * scale) * eye)
        l = torch.where(ok, l, retry)
    return l


def _as_matrix(v):
    return torch.diag(v) if v.ndim == 1 else v


def kalman_filter(model: DLM, ys, v, w, m0, c0) -> FilterResult:
    """Forward Kalman filter. ``ys: (T, d_obs)`` with NaNs for missing
    entries; ``v``: (d_obs, d_obs) or its diagonal (d_obs,); ``w``:
    (d_state, d_state) or its diagonal."""
    full_fp32()
    ys = as_tensor(ys, device=model.f.device)
    f, g = model.f, model.g
    d_state = f.shape[1]
    v_mat, w_mat = _as_matrix(v), _as_matrix(w)
    eye = torch.eye(d_state, dtype=ys.dtype, device=ys.device)
    m, c = m0, c0
    ll = torch.zeros((), dtype=ys.dtype, device=ys.device)
    out = []
    for y in ys:
        a = g @ m
        r = _sym(g @ c @ g.T + w_mat)
        mask = torch.isfinite(y)                     # observed entries
        y0 = torch.where(mask, y, 0.0)
        # missing entries: zero their rows of F, zero V's cross-covariances
        # with them (a non-diagonal V, as the DLM-GP's V = K(x, x), would
        # otherwise couple the missing pseudo-observations into the
        # innovation solve), and give them unit pseudo-variance
        mvec = mask.to(v_mat.dtype)
        f_eff = torch.where(mask[:, None], f, 0.0)
        v_eff = mvec[:, None] * v_mat * mvec[None, :] + torch.diag(1.0 - mvec)
        fhat = f_eff @ a
        q = f_eff @ r @ f_eff.T + v_eff
        e = torch.where(mask, y0 - fhat, 0.0)

        q_chol = _chol_psd(q)
        k_gain = chol.cho_solve(q_chol, f_eff @ r).mT    # R F^T Q^-1
        m = a + k_gain @ e
        # Joseph form: PSD by construction, where R - K F R cancels
        # catastrophically in float32
        ikf = eye - k_gain @ f_eff
        c = _sym(ikf @ r @ ikf.T + k_gain @ v_eff @ k_gain.T)

        u = chol.forward_solve(q_chol, e)
        n_obs = torch.sum(mask).to(ys.dtype)
        ll = ll + (-0.5 * (u @ u) - torch.sum(
            torch.where(mask, torch.log(torch.diagonal(q_chol)), 0.0))
            - 0.5 * n_obs * math.log(2.0 * math.pi))
        out.append((m, c, a, r))
    ms, cs, as_, rs = (torch.stack(t) for t in zip(*out))
    return FilterResult(m=ms, c=cs, a=as_, r=rs, log_likelihood=ll)


def _backward_gain(g, c, r_next):
    """``B = C G^T R_next^-1``."""
    return chol.cho_solve(_chol_psd(r_next), g @ c).mT


def ffbs(key, model: DLM, filtered: FilterResult, w=None):
    """Forward-filter backward-sample state draw, ``(T, d_state)``. ``key``
    is a ``torch.Generator``: one (T, d_state) block of standard normals,
    row t for time t.

    When the system covariance ``w`` is given, the backward covariance is
    the Joseph form ``(I - BG) C (I - BG)^T + B W B^T``: PSD by
    construction, where ``C - B R B^T`` cancels catastrophically in
    float32 once W has shrunk over Gibbs sweeps."""
    full_fp32()
    g = model.g
    ms, cs, as_, rs = filtered.m, filtered.c, filtered.a, filtered.r
    t_len, d_state = ms.shape
    w_mat = None if w is None else _as_matrix(w)
    eye = torch.eye(d_state, dtype=ms.dtype, device=ms.device)
    z = torch.randn((t_len, d_state), generator=key, dtype=ms.dtype,
                    device=key.device).to(ms.device)

    def draw(t, mean, cov):
        return mean + _chol_psd(cov) @ z[t]

    x = draw(t_len - 1, ms[-1], cs[-1])
    xs = [x]
    for t in range(t_len - 2, -1, -1):
        b = _backward_gain(g, cs[t], rs[t + 1])
        mean = ms[t] + b @ (x - as_[t + 1])
        if w_mat is None:
            cov = cs[t] - b @ rs[t + 1] @ b.T
        else:
            ibg = eye - b @ g
            cov = ibg @ cs[t] @ ibg.T + b @ w_mat @ b.T
        x = draw(t, mean, cov)
        xs.append(x)
    return torch.stack(xs[::-1])


def smooth(model: DLM, filtered: FilterResult):
    """RTS smoother: ``(means (T, d_state), covs (T, d_state,
    d_state))``."""
    full_fp32()
    g = model.g
    ms, cs, as_, rs = filtered.m, filtered.c, filtered.a, filtered.r
    s, ss = ms[-1], cs[-1]
    means, covs = [s], [ss]
    for t in range(ms.shape[0] - 2, -1, -1):
        b = _backward_gain(g, cs[t], rs[t + 1])
        s = ms[t] + b @ (s - as_[t + 1])
        ss = _sym(cs[t] + b @ (ss - rs[t + 1]) @ b.T)
        means.append(s)
        covs.append(ss)
    return torch.stack(means[::-1]), torch.stack(covs[::-1])


def forecast(model: DLM, m_last, c_last, v, w, n_ahead: int):
    """Iterated one-step-ahead forecast: ``(obs_means (n_ahead, d_obs),
    obs_covs (n_ahead, d_obs, d_obs))``."""
    full_fp32()
    f, g = model.f, model.g
    v_mat, w_mat = _as_matrix(v), _as_matrix(w)
    m, c = m_last, c_last
    means, covs = [], []
    for _ in range(n_ahead):
        m = g @ m
        c = _sym(g @ c @ g.T + w_mat)
        means.append(f @ m)
        covs.append(f @ c @ f.T + v_mat)
    return torch.stack(means), torch.stack(covs)


def sample_observation_variance(key, prior: InverseGamma, model: DLM, ys,
                                xs):
    """d-inverse-gamma Gibbs update of diagonal V given sampled states."""
    full_fp32()
    mask = torch.isfinite(ys)
    resid = torch.where(mask, ys - xs @ model.f.T, 0.0)   # (T, d_obs)
    n = torch.sum(mask, dim=0).to(ys.dtype)
    ss = torch.sum(resid ** 2, dim=0)
    post = InverseGamma(concentration=prior.concentration + 0.5 * n,
                        scale=prior.scale + 0.5 * ss)
    return _ig_draw(key, post, ys.shape[1])


def sample_system_variance(key, prior: InverseGamma, model: DLM, xs):
    """d-inverse-gamma Gibbs update of diagonal W given sampled states."""
    full_fp32()
    innov = xs[1:] - xs[:-1] @ model.g.T          # (T-1, d_state)
    ss = torch.sum(innov ** 2, dim=0)
    post = InverseGamma(concentration=prior.concentration
                        + 0.5 * innov.shape[0],
                        scale=prior.scale + 0.5 * ss)
    return _ig_draw(key, post, xs.shape[1])


def _ig_draw(key, post: InverseGamma, d: int):
    """Element-wise inverse-gamma draws with per-element concentration and
    scale, from the generator ``key``."""
    conc = post.concentration.to(post.scale.dtype)
    g = _standard_gamma(conc.to(key.device), (d,), key).to(post.scale.device)
    return post.scale / g


class ConjugateFilterResult(NamedTuple):
    m: torch.Tensor          # (T, d_state) state means
    c_star: torch.Tensor     # (T, d_state, d_state) scale-free state covs
    v_shape: torch.Tensor    # (T,) InverseGamma shape for the obs variance
    v_scale: torch.Tensor    # (T,) InverseGamma scale
    forecast_mean: torch.Tensor   # (T, d_obs) one-step-ahead means
    forecast_scale: torch.Tensor  # (T, d_obs) Student-t scales
    forecast_df: torch.Tensor     # (T,) Student-t degrees of freedom


def conjugate_filter(model: DLM, ys, w_star, m0, c0,
                     prior_v: InverseGamma) -> ConjugateFilterResult:
    """Kalman filter with the observation variance integrated out: ``V = v
    I`` with ``v ~ InverseGamma(a, b)`` updated conjugately each step, so
    one-step forecasts are Student-t with ``2a`` degrees of freedom.
    ``w_star`` is the system covariance relative to ``v``."""
    full_fp32()
    ys = as_tensor(ys, device=model.f.device)
    f, g = model.f, model.g
    d_obs, d_state = f.shape
    w_mat = _as_matrix(w_star)
    eye = torch.eye(d_state, dtype=ys.dtype, device=ys.device)
    # scale-free V* = I is diagonal, so masking its cross-covariances is a
    # no-op and the masked diagonal is the unit pseudo-variance
    v_star = torch.eye(d_obs, dtype=ys.dtype, device=ys.device)
    m, c = m0, c0
    a_v, b_v = prior_v.concentration, prior_v.scale
    out = []
    for y in ys:
        a = g @ m
        r = _sym(g @ c @ g.T + w_mat)
        mask = torch.isfinite(y)
        f_eff = torch.where(mask[:, None], f, 0.0)
        fhat = f_eff @ a
        q = f_eff @ r @ f_eff.T + v_star
        e = torch.where(mask, y - fhat, 0.0)

        q_chol = _chol_psd(q)
        u = chol.forward_solve(q_chol, e)
        k_gain = chol.cho_solve(q_chol, f_eff @ r).mT
        m = a + k_gain @ e
        ikf = eye - k_gain @ f_eff                   # Joseph form
        c = _sym(ikf @ r @ ikf.T + k_gain @ v_star @ k_gain.T)

        a_new = a_v + 0.5 * torch.sum(mask).to(ys.dtype)
        b_new = b_v + 0.5 * (u @ u)
        # Student-t one-step forecast: location fhat, scale from the
        # pre-update variance estimate b_v / a_v, df = 2 a_v
        scale = torch.sqrt((b_v / a_v) * torch.diagonal(q))
        out.append((m, c, fhat, scale, 2.0 * a_v, a_new, b_new))
        a_v, b_v = a_new, b_new
    ms, cs, fmeans, fscales, dfs, a_t, b_t = (torch.stack(t)
                                              for t in zip(*out))
    return ConjugateFilterResult(m=ms, c_star=cs, v_shape=a_t, v_scale=b_t,
                                 forecast_mean=fmeans,
                                 forecast_scale=fscales, forecast_df=dfs)


class GibbsResult(NamedTuple):
    v: torch.Tensor       # (iters, d_obs)
    w: torch.Tensor       # (iters, d_state)
    states: torch.Tensor  # (iters, T, d_state)


def gibbs_sample(key, model: DLM, ys, prior_v: InverseGamma,
                 prior_w: InverseGamma, m0, c0, n_iters: int, *, v0=None,
                 w0=None) -> GibbsResult:
    """FFBS-within-Gibbs for (states, V, W): each sweep filters at the
    current (V, W), draws the states by FFBS, then V and W from their
    conjugate posteriors. ``key``: an int seed or a ``torch.Generator``;
    sweep i draws, in that order, from the i-th of ``n_iters`` generators
    seeded from it."""
    ys = as_tensor(ys, device=model.f.device)
    d_obs, d_state = model.f.shape
    like = dict(dtype=ys.dtype, device=ys.device)
    v = torch.ones(d_obs, **like) if v0 is None else as_tensor(v0, **like)
    w = (torch.ones(d_state, **like) * 0.1 if w0 is None
         else as_tensor(w0, **like))
    vs, ws, states = [], [], []
    for gen in generators(key, n_iters, ys.device):
        filtered = kalman_filter(model, ys, v, w, m0, c0)
        xs = ffbs(gen, model, filtered, w)
        v = sample_observation_variance(gen, prior_v, model, ys, xs)
        w = sample_system_variance(gen, prior_w, model, xs)
        vs.append(v)
        ws.append(w)
        states.append(xs)
    return GibbsResult(v=torch.stack(vs), w=torch.stack(ws),
                       states=torch.stack(states))
