"""Term tables past the old 8-row cap, against the JAX package on the CPU:
the table's plain values and hyperparameter derivatives for a 24-factor
Product of Sums and a 72-factor one against gpx's ``evaluate_r2`` and its
autodiff (eager, float64), and the port's plain matvec routes for the
24-factor tree against gpx's eager matvecs.

``past_table`` is ``(SE + M3/2) (Per + RQ) (SE + White)``: 8 products of 3
factors. ``wide72`` is ``(SE + M3/2 + RQ + Per) (SE + Per + M5/2) (SE +
White)``: 24 products of 3 factors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.ops import pallas_matvec as jpm
from gpx_torch.kernels import expanded_size
from gpx_torch.ops import matvec as tmv
from gpx_torch.ops import terms

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-10, atol=1e-14)


def _tree(m, name, **kw):
    """The tree in the module ``m`` (gpx or gpx_torch, whose constructors
    take ``kw``), with the same hyperparameters in both."""
    se1, se2 = m.se(2.0, 3.0, **kw), m.se(1.0, 4.0, **kw)
    if name == "past_table":
        return ((se1 + m.matern(1.0, 1.5, 2.0, **kw))
                * (m.periodic(1.0, 2.5, 1.5, **kw)
                   + m.rational_quadratic(1.0, 0.7, 2.0, **kw))
                * (se2 + m.white(0.1, **kw)))
    return m.Product((
        se1 + m.matern(1.0, 1.5, 2.0, **kw)
        + m.rational_quadratic(0.8, 0.7, 2.0, **kw)
        + m.periodic(1.0, 2.5, 1.5, **kw),
        m.se(1.5, 2.0, **kw) + m.periodic(0.9, 3.1, 1.4, **kw)
        + m.matern(1.1, 2.5, 3.0, **kw),
        se2 + m.white(0.1, **kw)))


@pytest.mark.parametrize("name, factors", [("past_table", 24), ("wide72", 72)])
def test_wide_table_against_gpx(name, factors):
    """``term_values`` and ``term_derivatives`` (a leaf in several products
    sums its products' terms) at 64 squared distances, two of them 0,
    against gpx's ``evaluate_r2`` and its Jacobian in the kernel's leaves,
    to 1e-10 relative (``term_dr2`` is held against autograd in
    test_torch_products.py)."""
    kt, kj = _tree(gt, name, **F64), _tree(gpx, name)
    assert expanded_size(kt)[1] == len(terms._rows(kt)) == factors
    r2 = np.concatenate([[0.0, 0.0],
                         np.random.default_rng(3).uniform(0.01, 30.0, 62)])
    rt, rj = torch.as_tensor(r2), jnp.asarray(r2)
    np.testing.assert_allclose(terms.term_values(kt, rt).numpy(),
                               np.asarray(kj.evaluate_r2(rj)), **TOL)
    want = jax.tree_util.tree_leaves(jax.jacrev(lambda k: k.evaluate_r2(rj))(kj))
    got = terms.term_derivatives(kt, rt)
    assert len(got) == len(want) == len(gt.params.leaves(kt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("which", ["gram", "cross"])
def test_wide_table_matvec_against_gpx(which):
    """The port's matvec dispatch for the 24-factor tree on CPU tensors (the
    kernels' plain routes) against gpx's eager matvecs at n = 256, D = 2,
    float64: ``gram_matvec`` with a nugget, ``cross_matvec`` with points
    shared across the sets (White fires there)."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-4.0, 4.0, (256, 2))
    v = rng.normal(size=(256, 3))
    kt, kj = _tree(gt, "past_table", **F64), _tree(gpx, "past_table")
    if which == "gram":
        got = tmv.gram_matvec(kt, torch.as_tensor(x), torch.as_tensor(v),
                              nugget=1e-3)
        want = jpm.gram_matvec(kj, x, v, nugget=1e-3)
    else:
        x1 = np.concatenate([x[:16], rng.uniform(-4.0, 4.0, (112, 2))])
        got = tmv.cross_matvec(kt, torch.as_tensor(x1), torch.as_tensor(x),
                               torch.as_tensor(v))
        want = jpm.cross_matvec(kj, x1, x, v)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               rtol=0, atol=1e-12 * np.abs(want).max())
