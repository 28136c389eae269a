"""The S0 leftovers on the CPU in float64 against the JAX package: the
Bessel ``K_nu`` (gpx_torch.ops.besselk) and its x-derivative, the
general-nu Matérn it enables (Gram, logML and gradient; the hybrid's gate;
carried across by ``convert``), and ``StudentT.cdf``/``ppf`` with
``student_t_interval``. Every gpx oracle runs in one jitted program."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx import distributions as jdist
from gpx.models import gp as jgp
from gpx.ops.besselk import kv as jkv
from gpx_torch import distributions as tdist
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy, params_to_numpy
from gpx_torch.models import gp
from gpx_torch.ops.besselk import kv

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}
NUS = (0.05, 0.5, 1.3, 3.7, 10.0)
X_KV = np.geomspace(1e-6, 30.0, 200)
DFS = (0.7, 3.0, 30.0)
Z_T = np.linspace(-40.0, 40.0, 161)
Q_T = np.array([1e-6, 0.025, 0.3, 0.5, 0.9, 0.975])
NU_M = 1.3  # a Matérn order off the half-integers
DNUS = (0.3, NU_M)  # orders whose x-derivative is held (K_nu-1 below 0)


def _jparams():
    return gpx.Parameters(mean=gpx.plane([0.2, -0.1, 0.3]),
                          kernel=gpx.matern(1.7, NU_M, 2.3) + gpx.white(0.4))


def _oracle(x, y, xt):
    """Every gpx number the tests read, in one program."""
    out = {"kv": jnp.stack([jkv(nu, x) for nu in NUS]),
           "dkv": jnp.stack([jax.vmap(jax.grad(lambda v, nu=nu: jkv(nu, v)))(x)
                             for nu in DNUS])}
    p = _jparams()
    out["gram"] = p.kernel.gram(xt, nugget=1e-3)
    out["logml"] = jgp.log_marginal_likelihood(p, xt, y)
    df = jnp.asarray(DFS)[:, None]
    t = jdist.StudentT(df, jnp.asarray(0.3), jnp.asarray(2.0))
    out["cdf"], out["ppf"] = t.cdf(Z_T), t.ppf(Q_T)
    out["interval"] = jdist.student_t_interval(0.3, 2.0, df, Q_T)
    return out


@pytest.fixture(scope="module")
def want():
    rng = np.random.default_rng(3)
    xt = rng.uniform(-4, 4, size=(30, 2))
    xt[7] = xt[3]  # a coincident pair: White fires, the Matérn takes s = 0
    y = rng.normal(size=30)
    out = jax.jit(_oracle, compiler_options=_FAST_COMPILE)(
        jnp.asarray(X_KV), jnp.asarray(y), jnp.asarray(xt))
    out = jax.tree_util.tree_map(np.asarray, out)
    out.update(xt=xt, y=y)
    return out


def test_kv_matches_gpx(want):
    """K_nu to 1e-12 relative over x in [1e-6, 30] and nu in (0, 10],
    both regimes and the recurrence; K_-nu = K_nu."""
    x = torch.as_tensor(X_KV)
    for i, nu in enumerate(NUS):
        np.testing.assert_allclose(kv(nu, x).numpy(), want["kv"][i],
                                   rtol=1e-12, atol=0)
    assert torch.equal(kv(-1.3, x), kv(1.3, x))


def test_kv_derivative_matches_gpx(want):
    """The x-derivative -(K_{nu-1} + K_{nu+1}) / 2 against gpx's
    ``jax.grad`` through its custom_jvp; finite at both regimes' joint
    (x = 2) and once more (the backward is itself differentiable)."""
    for i, nu in enumerate(DNUS):
        x = torch.as_tensor(X_KV).requires_grad_()
        (g,) = torch.autograd.grad(kv(nu, x).sum(), x)
        np.testing.assert_allclose(g.numpy(), want["dkv"][i], rtol=1e-12)
    x = torch.tensor([2.0], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(kv(NU_M, x).sum(), x, create_graph=True)
    (g2,) = torch.autograd.grad(g.sum(), x)
    assert torch.isfinite(g).all() and torch.isfinite(g2).all()
    assert float(g2) > 0  # K_nu is convex


def test_general_nu_matern_matches_gpx(want):
    """A Plane mean over Matérn(1.7, nu = 1.3, 2.3) + White(0.4) on D = 2,
    carried across by convert (the template's nu, gpx's leaves): the Gram
    (a coincident pair among the points) to 1e-13, the logML to 1e-10 on
    both gradient routes, whose gradients (autograd through ``kv``'s
    recurrence derivative, and the trace identity) agree to 1e-10; the
    route is torch's (no CUDA device function), and the hybrid refuses
    it as gpx's does."""
    template = gt.Parameters(mean=gt.plane([0.0, 0.0, 0.0], **F64),
                             kernel=gt.matern(1.0, NU_M, 1.0, **F64)
                             + gt.white(1.0, **F64))
    tp = params_from_numpy(template, jax.tree_util.tree_leaves(_jparams()))
    assert tp.kernel.kernels[0].nu == NU_M
    for a, b in zip(params_to_numpy(tp),
                    jax.tree_util.tree_leaves(_jparams())):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert not tp.kernel.cuda_supported and not tp.kernel.pallas_safe
    x, y = torch.as_tensor(want["xt"]), torch.as_tensor(want["y"])
    np.testing.assert_allclose(tp.kernel.gram(x, nugget=1e-3).numpy(),
                               want["gram"], rtol=1e-13, atol=1e-15)
    grads = []
    for method in ("autodiff", "analytic"):
        value, g = gp.logml_value_and_grad(tp, x, y, method=method)
        np.testing.assert_allclose(float(value), float(want["logml"]),
                                   rtol=1e-10)
        grads.append(tparams.to_array(g).numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-10)
    assert np.all(np.abs(grads[0]) > 1e-3)
    with pytest.raises(ValueError, match="stationary Pallas-safe"):
        gp.logml_value_and_grad(tp, x, y, method="hybrid")


def test_student_t_cdf_ppf_interval_match_gpx(want):
    """StudentT.cdf to 1e-13 absolute over z in [-40, 40] for df 0.7, 3
    and 30 at once (the incomplete beta's continued fraction), and
    student_t_interval, which is StudentT.ppf's 90 bisections, on the
    same grid of df and quantiles against both of gpx's to 1e-9
    relative."""
    t = tdist.StudentT(torch.tensor(DFS, dtype=torch.float64)[:, None],
                       torch.tensor(0.3, dtype=torch.float64),
                       torch.tensor(2.0, dtype=torch.float64))
    np.testing.assert_allclose(t.cdf(torch.as_tensor(Z_T)).numpy(),
                               want["cdf"], rtol=0, atol=1e-13)
    assert (t.cdf(torch.tensor(0.3, dtype=torch.float64)) == 0.5).all()
    got = tdist.student_t_interval(torch.tensor(0.3, dtype=torch.float64),
                                   2.0, t.df, Q_T).numpy()
    np.testing.assert_allclose(got, want["ppf"], rtol=1e-9)
    np.testing.assert_allclose(got, want["interval"], rtol=1e-9)
    ends = tdist.betainc(torch.tensor([2.0, 2.0]), torch.tensor([0.5, 0.5]),
                         torch.tensor([0.0, 1.0], dtype=torch.float64))
    assert ends.tolist() == [0.0, 1.0]
