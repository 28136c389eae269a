"""The port's plots against gpx's: each of the nine functions, fed the same
numpy inputs (and the port's also tensors), draws the same artists' data;
the PNG is written; and ``gpx_torch.plots`` imports without matplotlib."""

import ast
import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx.plots as gplots
from gpx.models import gp as jgp
from gpx_torch import plots as tplots
from gpx_torch.models import gp as tgp

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-12  # float64 inputs; the ACF (FFT) and the quantile (ndtri) differ
              # between jax and torch in the last bits only


def _artists(fig):
    """Every axes' line data, collection offsets and paths, bar and
    histogram rectangles, labels, titles and legend texts."""
    out = []
    for ax in fig.axes:
        out.append({
            "lines": [ln.get_xydata() for ln in ax.get_lines()],
            "offsets": [c.get_offsets() for c in ax.collections],
            "paths": [p.vertices for c in ax.collections
                      for p in c.get_paths()],
            "patches": [(r.get_x(), r.get_y(), r.get_width(), r.get_height())
                        for r in ax.patches],
            "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
            "legend": [t.get_text() for t in ax.get_legend().get_texts()]
            if ax.get_legend() else [],
        })
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["labels"] == w["labels"] and g["legend"] == w["legend"]
        for key in ("lines", "offsets", "paths", "patches"):
            assert len(g[key]) == len(w[key]), key
            for a, b in zip(g[key], w[key]):
                np.testing.assert_allclose(np.asarray(a, float),
                                           np.asarray(b, float), rtol=RTOL,
                                           atol=RTOL)


def _inputs():
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(-5, 5, 30))
    return {
        "x": x, "x2": x[:, None], "y": np.sin(x) + 0.1 * rng.normal(size=30),
        "curves": rng.normal(size=(4, 30)),
        "draws": rng.normal(size=(2, 50)).cumsum(-1),
        "flat": rng.normal(size=(2, 40, 3)),
        "xy": rng.uniform(size=(40, 2)), "var": rng.uniform(0.1, 1.0, 30),
    }


def _summary(m, d):
    if m is tplots:
        return tgp.PosteriorSummary(*(torch.as_tensor(v) for v in (
            d["x2"], d["y"], d["var"])))
    return jgp.PosteriorSummary(x=jnp.asarray(d["x2"]), mean=jnp.asarray(
        d["y"]), variance=jnp.asarray(d["var"]))


CALLS = {
    "scatter_plot": lambda m, a: m.scatter_plot(a["x2"], a["y"]),
    "gp_plot": lambda m, a: m.gp_plot(_summary(m, a), obs=(a["x"], a["y"])),
    "pp_plot": lambda m, a: m.pp_plot(a["x"], a["curves"]),
    "traceplot": lambda m, a: m.traceplot(a["draws"]),
    "histogram": lambda m, a: m.histogram(a["draws"], bins=12),
    "autocorrelation_plot": lambda m, a: m.autocorrelation_plot(
        a["draws"][0], max_lag=15),
    "diagnostic_plots": lambda m, a: m.diagnostic_plots(
        a["flat"], ["h", "sigma", "white"]),
    "contour_plot": lambda m, a: m.contour_plot(
        a["xy"], a["xy"][:, 0] * a["xy"][:, 1], levels=6),
}


@pytest.mark.parametrize("name", [*CALLS, "savefig"])
def test_plots_match_gpx(tmp_path, name):
    """The port's figure, from numpy arrays and from tensors, against
    gpx's from the arrays; ``savefig`` writes the PNG and closes the
    figure, as gpx's does."""
    from matplotlib import pyplot as plt

    d = _inputs()
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    if name == "savefig":
        fig = CALLS["pp_plot"](tplots, t)
        path = tplots.savefig(fig, tmp_path / "out" / "pp.png", dpi=20)
        assert path == tmp_path / "out" / "pp.png"
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert not plt.fignum_exists(fig.number)
        return
    want = _artists(CALLS[name](gplots, d))
    for inputs in (d, t):
        _same(_artists(CALLS[name](tplots, inputs)), want)
    plt.close("all")


def test_plots_import_without_matplotlib(monkeypatch):
    """No module-level matplotlib import (AST), and the module imports with
    matplotlib unavailable, raising only when asked to draw."""
    path = ROOT / "gpx_torch" / "plots.py"
    tree = ast.parse(path.read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m and m.split(".")[0] == "matplotlib"]

    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    spec = importlib.util.spec_from_file_location("_plots_bare", path)
    bare = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bare)
    with pytest.raises(ImportError):
        bare.scatter_plot(np.zeros(3), np.zeros(3))
