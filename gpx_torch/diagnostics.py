"""MCMC diagnostics: ACF, ESS, split-R-hat and posterior summaries — the
port of ``gpx/diagnostics.py`` (the reference's ``Diagnostics``, whose
``acf`` divides by ``sum(x - mean)``, a quantity ~0 by construction,
Diagnostics.scala:19-28; here ``gamma(lag) / gamma(0)`` by FFT). Torch
functions of tensors on any device; ``summary`` returns Python floats.
"""

from __future__ import annotations

import math

import torch


def _as_float(x):
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def acf(x, max_lag: int = 30):
    """Autocorrelation at lags ``0 .. max_lag`` (by FFT)."""
    x = _as_float(x)
    n = x.shape[0]
    xc = x - torch.mean(x)
    size = int(2 ** math.ceil(math.log2(max(2 * n, 2))))
    f = torch.fft.rfft(xc, size)
    autocov = torch.fft.irfft(f * torch.conj(f), size)[: max_lag + 1] / n
    return autocov / autocov[0]


def autocorrelation(x, lag: int):
    """The autocorrelation at one lag (the corrected Diagnostics.acf)."""
    return float(acf(x, lag)[lag])


def ess(x):
    """Effective sample size by Geyer's initial monotone positive sequence:
    pair sums of the autocorrelation, cut at the first negative pair and
    made non-increasing by a running minimum."""
    x = _as_float(x)
    n = x.shape[0]
    rho = acf(x, max_lag=min(n - 2, 1000))
    pair = rho[1:-1:2] + rho[2::2]
    valid = torch.cumprod((pair >= 0.0).to(pair.dtype), 0) > 0
    running_min = torch.cummin(pair, 0).values
    tau = 1.0 + 2.0 * torch.sum(torch.where(valid, running_min, 0.0))
    return n / tau


def split_rhat(chains):
    """Split-R-hat (Gelman et al.) of ``(n_chains, n_draws)`` draws."""
    c = _as_float(chains)
    if c.ndim == 1:
        c = c[None, :]
    n = c.shape[1]
    half = n // 2
    splits = torch.cat([c[:, :half], c[:, half:2 * half]], dim=0)
    n2 = splits.shape[1]
    chain_means = torch.mean(splits, dim=1)
    w = torch.mean(torch.var(splits, dim=1, correction=1))
    b = n2 * torch.var(chain_means, correction=1)
    var_plus = (n2 - 1) / n2 * w + b / n2
    return torch.sqrt(var_plus / w)


def _summary_stats(flat):
    """Every per-parameter statistic of ``(n_chains, n_draws, dim)`` draws."""
    pooled = flat.reshape(-1, flat.shape[-1])
    q = torch.tensor([0.05, 0.5, 0.95], dtype=flat.dtype, device=flat.device)
    qs = torch.quantile(pooled, q, dim=0)
    ess_cp = torch.stack([torch.stack([ess(flat[c, :, j])
                                       for j in range(flat.shape[2])])
                          for c in range(flat.shape[0])])
    return {
        "mean": torch.mean(pooled, dim=0),
        "sd": torch.std(pooled, dim=0, correction=1),
        "median": qs[1],
        "q5": qs[0],
        "q95": qs[2],
        "ess": torch.sum(ess_cp, dim=0),
        "rhat": torch.stack([split_rhat(flat[:, :, j])
                             for j in range(flat.shape[2])]),
    }


def summary(flat, names):
    """Per-parameter posterior table from ``(n_chains, n_draws, dim)``
    draws: mean, sd, median, central 90% interval, ESS (summed over the
    chains) and split-R-hat."""
    flat = _as_float(flat)
    if flat.ndim == 2:
        flat = flat[None]
    stats = {k: v.tolist() for k, v in _summary_stats(flat).items()}
    return {name: {k: float(v[j]) for k, v in stats.items()}
            for j, name in enumerate(names)}


def format_summary(rows: dict) -> str:
    header = (f"{'param':<22}{'mean':>10}{'sd':>10}{'5%':>10}{'95%':>10}"
              f"{'ess':>9}{'rhat':>8}")
    lines = [header]
    for name, r in rows.items():
        lines.append(
            f"{name:<22}{r['mean']:>10.4f}{r['sd']:>10.4f}{r['q5']:>10.4f}"
            f"{r['q95']:>10.4f}{r['ess']:>9.0f}{r['rhat']:>8.3f}")
    return "\n".join(lines)
