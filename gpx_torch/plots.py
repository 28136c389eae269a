"""Plotting: GP fits, posterior-predictive spaghetti, MCMC diagnostics —
the port of ``gpx/plots.py``, with the same functions and figures.

Rebuild of ``Plot`` (core/src/main/scala/gp/Plot.scala) and the plot half
of ``Diagnostics`` (Diagnostics.scala:33-87), with matplotlib replacing
EvilPlot. Every function takes tensors on any device or arrays and returns
the Figure; ``savefig`` writes PNG like the reference's docs figures.

matplotlib is imported when a function draws (:func:`_plt`), never when
this module is imported: a machine without it imports the module and
raises only when asked to draw.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from gpx_torch import diagnostics as diag


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _x1d(x):
    x = _np(x)
    if x.ndim == 2:
        if x.shape[1] != 1:
            raise ValueError(
                "1-D plots need one-dimensional locations "
                "(Plot.scala:27 raises the same way)"
            )
        x = x[:, 0]
    return x


def scatter_plot(x, y, ax=None):
    """Plot.scatterPlot (Plot.scala:20-28)."""
    fig, ax = _get_ax(ax)
    ax.scatter(_x1d(x), _np(y), s=12, color="#1f77b4", zorder=3)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    return fig


def gp_plot(summary, obs=None, interval=0.95, ax=None):
    """Posterior mean ± credible band — Plot.gpPlot (Plot.scala:34-52).

    ``summary``: a ``gpx_torch.models.gp.PosteriorSummary``; ``obs``:
    optional ``(x, y)``.
    """
    fig, ax = _get_ax(ax)
    xs = _x1d(summary.x)
    order = np.argsort(xs)
    mean = _np(summary.mean)[order]
    lo = _np(summary.interval(1.0 - interval))[order]
    hi = _np(summary.interval(interval))[order]
    ax.fill_between(xs[order], lo, hi, alpha=0.25, color="#1f77b4",
                    label=f"{interval:.0%} band")
    ax.plot(xs[order], mean, color="#1f77b4", label="posterior mean")
    if obs is not None:
        ax.scatter(_x1d(obs[0]), _np(obs[1]), s=14, color="black", zorder=3,
                   label="observations")
    ax.legend()
    ax.set_xlabel("x")
    return fig


def pp_plot(xs, mean_curves, ax=None):
    """Posterior-predictive spaghetti — Plot.ppPlot (Plot.scala:54-64)."""
    fig, ax = _get_ax(ax)
    x = _x1d(xs)
    order = np.argsort(x)
    for curve in _np(mean_curves):
        ax.plot(x[order], curve[order], color="red", alpha=0.35,
                linewidth=0.8)
    ax.set_xlabel("x")
    return fig


def traceplot(draws, ax=None):
    """Diagnostics.traceplot (Diagnostics.scala:51-58); accepts (n,) or
    (chains, n)."""
    fig, ax = _get_ax(ax)
    for c in np.atleast_2d(_np(draws)):
        ax.plot(c, linewidth=0.6)
    ax.set_xlabel("Iteration")
    return fig


def histogram(draws, ax=None, bins=40):
    """Diagnostics.histogram (Diagnostics.scala:68-73)."""
    fig, ax = _get_ax(ax)
    ax.hist(_np(draws).reshape(-1), bins=bins, color="#1f77b4", alpha=0.8)
    return fig


def autocorrelation_plot(draws, max_lag=30, ax=None):
    """Diagnostics.autocorrelation (Diagnostics.scala:33-39), with the
    corrected ACF."""
    fig, ax = _get_ax(ax)
    rho = _np(diag.acf(_np(draws).reshape(-1), max_lag))
    ax.bar(np.arange(len(rho)), rho, color="#1f77b4")
    ax.set_xlabel("lag")
    ax.set_ylabel("acf")
    return fig


def diagnostic_plots(flat, names):
    """Faceted traceplot + histogram per parameter — Diagnostics.diagnostics
    (Diagnostics.scala:82-87). ``flat``: (chains, draws, dim)."""
    flat = _np(flat)
    if flat.ndim == 2:
        flat = flat[None]
    dim = flat.shape[-1]
    fig, axes = _plt().subplots(2, dim, figsize=(4 * dim, 6), squeeze=False)
    for j, name in enumerate(names):
        traceplot(flat[:, :, j], ax=axes[0][j])
        axes[0][j].set_title(name)
        histogram(flat[:, :, j], ax=axes[1][j])
    fig.tight_layout()
    return fig


def contour_plot(x, values, ax=None, levels=20):
    """Contour plot of a GP over 2-D locations — the capability the
    reference sketched but left commented out (Plot.scala:69-81).

    ``x``: (N, 2) locations, ``values``: (N,) e.g. posterior mean.
    """
    fig, ax = _get_ax(ax)
    x = _np(x)
    if x.ndim != 2 or x.shape[1] != 2:
        raise ValueError("contour plot needs two-dimensional location data")
    tri = ax.tricontourf(x[:, 0], x[:, 1], _np(values), levels=levels)
    fig.colorbar(tri, ax=ax)
    ax.set_xlabel("x1")
    ax.set_ylabel("x2")
    return fig


def savefig(fig, path, dpi=120):
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    _plt().close(fig)
    return path


def _get_ax(ax):
    if ax is None:
        fig, ax = _plt().subplots(figsize=(8, 5))
        return fig, ax
    return ax.figure, ax
