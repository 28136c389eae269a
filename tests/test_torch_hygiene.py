"""The port stands alone: no JAX and nothing of ``gpx`` in ``gpx_torch`` or
``chip_smoke.py``, and no quiet fall-back to the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import gpx_torch as gt

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "gpx_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_gpx_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "gpx")]
    assert not bad, f"{path.name} imports {bad}"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert gt.se(1.0, 2.0).h.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            gt.se(1.0, 2.0)
        with pytest.raises(RuntimeError):
            gt.plane([0.0, 1.0])


def test_sampler_entry_points_default_to_the_card():
    """sample_hmc and the two VJPs put numpy x and y on the card: without
    one they raise, with one the log-likelihood lands there."""
    from gpx_torch.infer import sample_hmc
    from gpx_torch.models import gp

    x, y = np.linspace(-1.0, 1.0, 8)[:, None], np.zeros(8)
    cpu = dict(device="cpu", dtype=torch.float64)
    template = gt.Parameters(mean=gt.zero(),
                             kernel=gt.se(1.0, 2.0, **cpu) + gt.white(0.5, **cpu))
    vjps = (gp.log_marginal_likelihood_analytic_vjp,
            gp.log_marginal_likelihood_hybrid_vjp)
    if torch.cuda.is_available():
        card = gt.params.unflatten(template, [t.cuda() for t in
                                              gt.params.leaves(template)])
        for make in vjps:
            assert make(x, y)(card).device.type == "cuda"
        return
    for make in vjps:
        with pytest.raises(RuntimeError):
            make(x, y)
    with pytest.raises(RuntimeError):
        sample_hmc(0, x, y, template, lambda p: 0.0, 2, n_chains=1, eps=0.1)
