"""A Gram that is not positive definite: the port returns NaN and, with
``safe=True``, ``-inf``, as the JAX package does, instead of raising; and
``safe_cholesky`` escalates the nugget as the JAX package's does. Float64
on the CPU; gpx's results come from one jitted program per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.models import gp as jgp
from gpx.ops.safe_chol import safe_cholesky as jax_safe_cholesky
from gpx_torch import params as tparams
from gpx_torch.models import gp
from gpx_torch.ops.chol import cholesky
from gpx_torch.ops.safe_chol import chol_ok, safe_cholesky

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
NUGGET = -1e-3  # SE(1, 200) on 300 points in [-10, 10] is numerically
                # rank-deficient: a negative nugget makes it indefinite


def _case():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-10.0, 10.0, size=300))
    return x, rng.normal(size=300)


def _near_singular():
    """SE(1, 3) on 120 sorted points, numerically singular: the bare factor
    fails and a small nugget rescues it."""
    x = np.sort(np.random.default_rng(1).uniform(-10.0, 10.0, size=120))
    k = np.exp(-(x[:, None] - x[None, :]) ** 2 / 9.0)
    return k


@pytest.fixture(scope="module")
def oracle():
    x, y = _case()
    jp = gpx.Parameters(mean=gpx.zero(), kernel=gpx.se(1.0, 200.0))

    def run(p, a, b, k):
        return (jgp.log_marginal_likelihood(p, a, b, nugget=NUGGET),
                jgp.log_marginal_likelihood(p, a, b, nugget=NUGGET, safe=True),
                jgp.logml_value_and_grad(p, a, b, nugget=NUGGET),
                jgp.logml_value_and_grad(p, a, b, nugget=NUGGET,
                                         method="autodiff"),
                jax_safe_cholesky(k))

    return jax.jit(run)(jp, jnp.asarray(x), jnp.asarray(y),
                        jnp.asarray(_near_singular()))


def _port():
    x, y = _case()
    tp = gt.Parameters(mean=gt.zero(), kernel=gt.se(1.0, 200.0, **F64))
    return tp, torch.as_tensor(x), torch.as_tensor(y)


def test_not_positive_definite_gives_nan_and_safe_inf(oracle):
    lml, lml_safe, (v_an, g_an), (v_ad, g_ad), _ = oracle
    assert np.isnan(float(lml)) and float(lml_safe) == -np.inf
    tp, x, y = _port()
    assert torch.isnan(gp.log_marginal_likelihood(tp, x, y, nugget=NUGGET))
    assert float(gp.log_marginal_likelihood(tp, x, y, nugget=NUGGET,
                                            safe=True)) == -np.inf
    for method, (jv, jg) in (("analytic", (v_an, g_an)),
                             ("autodiff", (v_ad, g_ad))):
        value, grads = gp.logml_value_and_grad(tp, x, y, nugget=NUGGET,
                                               method=method)
        got = [float(value)] + [float(t) for t in tparams.leaves(grads)]
        want = [float(jv)] + [float(t) for t in jax.tree_util.tree_leaves(jg)]
        assert len(got) == len(want) and np.all(np.isnan(got)), (method, got)
        assert np.all(np.isnan(want))


def test_fused_core_gives_nan(oracle):
    """The fused leg through the plain versions of its kernels (the card's
    leaf takes a reciprocal root of a negative pivot: NaN too)."""
    tp, x, y = _port()
    x = x[:, None]
    k = gp.gram(tp.kernel, x, nugget=NUGGET)
    value, d_kernel, _ = gp._fused_logml_core(tp.kernel, x, y, k, NUGGET)
    assert torch.isnan(value)
    assert all(torch.isnan(t) for t in tparams.leaves(d_kernel))


def test_safe_cholesky_matches_gpx_nugget(oracle):
    want = oracle[4]
    k = torch.as_tensor(_near_singular())
    assert not bool(chol_ok(cholesky(k)))
    got = safe_cholesky(k)
    assert float(got.nugget_used) == float(want.nugget_used) > 0.0
    assert bool(got.failed) == bool(want.failed) is False
    # the factor of an ill-conditioned matrix differs between LAPACKs
    # (8e-9 here); its backward error does not
    l = got.chol
    resid = l @ l.T - (k + float(want.nugget_used) * torch.eye(k.shape[0],
                                                                dtype=k.dtype))
    assert float(resid.abs().max()) < 1e-14
    # every rung failing: NaN factor, NaN nugget, failed
    bad = safe_cholesky(-torch.eye(3, dtype=torch.float64))
    assert bool(bad.failed) and torch.isnan(bad.chol).all()
    assert torch.isnan(bad.nugget_used)
