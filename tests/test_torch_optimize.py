"""Type-II ML / MAP on the CPU in float64 (gpx_torch.models.optimize)
against the JAX package: Adam step for step (gpx's objective under
``jax.value_and_grad``, ``optax.adam`` in an eager loop), L-BFGS at its
optimum (gpx's gradient there), the argument checks, and the stochastic
routes by their own properties. No gpx optimizer scan is compiled here."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx import params as jparams
from gpx.distributions import Gamma as JGamma
from gpx.models import gp as jgp
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy
from gpx_torch.distributions import Gamma
from gpx_torch.models import gp
from gpx_torch.models.optimize import (
    optimize, optimize_log_density, stochastic_log_density_vjp,
)

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
N = 48
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}
# a Gamma(20, rate 4) prior (mean 5, sd 1.1) on the SE lengthscale: it
# pulls the MAP (3.01) away from the MLE (2.07)
PRIOR = (20.0, 4.0)


def _jprior(p):
    return JGamma(jnp.asarray(PRIOR[0]), jnp.asarray(PRIOR[1])).logpdf(
        p.kernel.kernels[0].sigma)


def _tprior(p):
    return Gamma(torch.tensor(PRIOR[0], dtype=torch.float64),
                 torch.tensor(PRIOR[1], dtype=torch.float64)).logpdf(
        p.kernel.kernels[0].sigma)


@pytest.fixture(scope="module")
def case():
    """n = 48 points of a smooth signal plus noise; gpx's objectives
    (negative log posterior in unconstrained space, value and gradient):
    autodiff through the Cholesky with the prior's weight an argument (0
    or 1), and the analytic VJP; each with one ``optax.adam`` step, jitted
    once, for the eager Adam loop."""
    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(-10, 10, size=(N, 1)), axis=0)
    y = 2.0 * np.sin(x[:, 0]) + 0.5 * rng.normal(size=N)
    jinit = gpx.Parameters(mean=gpx.zero(),
                           kernel=gpx.se(0.8, 1.0) + gpx.white(1.5))
    tinit = params_from_numpy(
        gt.Parameters(mean=gt.zero(),
                      kernel=gt.se(1.0, 1.0, **F64) + gt.white(1.0, **F64)),
        jax.tree_util.tree_leaves(jinit))
    bij = jinit.bijectors()
    flat0, unravel = jparams.unraveler(jparams.unconstrain(bij, jinit))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    analytic = jgp.log_marginal_likelihood_analytic_vjp(jx, jy)

    def neg(ll, prior_w):
        def f(u):
            p = jparams.constrain(bij, unravel(u))
            return -(ll(p) + prior_w * _jprior(p))
        return f

    adam = optax.adam(0.05)

    def with_adam(f):
        def step(u, state):
            value, grad = jax.value_and_grad(f)(u)
            updates, state = adam.update(grad, state, u)
            return value, grad, optax.apply_updates(u, updates), state
        return jax.jit(step, compiler_options=_FAST_COMPILE)

    auto = jax.jit(lambda u, w: jax.value_and_grad(neg(
        lambda p: jgp.log_marginal_likelihood(p, jx, jy), w))(u),
        compiler_options=_FAST_COMPILE)
    return dict(x=torch.as_tensor(x), y=torch.as_tensor(y), tinit=tinit,
                flat0=flat0, bij=bij, adam=adam, steps={
                    "autodiff": with_adam(neg(
                        lambda p: jgp.log_marginal_likelihood(p, jx, jy),
                        0.0)),
                    "analytic": with_adam(neg(analytic, 0.0))},
                oracles={"autodiff": lambda u: auto(u, 0.0),
                         "prior": lambda u: auto(u, 1.0)})


def _u(case, params):
    """The port's constrained parameters as gpx's flat unconstrained
    vector."""
    jp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(gpx.Parameters(
            mean=gpx.zero(), kernel=gpx.se(1.0, 1.0) + gpx.white(1.0))),
        [jnp.asarray(t.numpy()) for t in tparams.leaves(params)])
    return jparams.to_array(jparams.unconstrain(case["bij"], jp))


@pytest.mark.parametrize("method", ["autodiff", "analytic"])
def test_adam_matches_gpx_step_for_step(case, method):
    """25 Adam steps: optax.adam on gpx's objective in an eager loop, and
    the port's optimize(optimizer="adam"); every traced value and the
    final parameters within 1e-10 relative."""
    steps = 25
    res = optimize(case["tinit"], case["x"], case["y"], steps=steps,
                   optimizer="adam", learning_rate=0.05, method=method)
    step = case["steps"][method]
    u, state = case["flat0"], case["adam"].init(case["flat0"])
    want = []
    for _ in range(steps + 1):  # the last call: the value at the result
        value, _, u_next, state = step(u, state)
        want.append(-float(value))
        u, u_prev = u_next, u
    assert res.values.shape == (steps,)
    np.testing.assert_allclose(res.values.numpy(), want[:-1], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(_u(case, res.params)),
                               np.asarray(u_prev), rtol=1e-10)
    np.testing.assert_allclose(float(res.value), want[-1], rtol=1e-10)


@pytest.mark.parametrize("with_prior", [False, True])
def test_lbfgs_optimum_is_stationary_for_gpx(case, with_prior):
    """The port's L-BFGS optimum: gpx's gradient there below 1e-5, gpx's
    objective equal to the port's value to 1e-10 relative; converged; the
    prior moves the optimum."""
    kw = dict(log_prior=_tprior) if with_prior else {}
    res = optimize(case["tinit"], case["x"], case["y"], steps=40, **kw)
    value, grad = case["oracles"]["prior" if with_prior else "autodiff"](
        _u(case, res.params))
    assert float(jnp.linalg.norm(grad)) < 1e-5
    np.testing.assert_allclose(float(res.value), -float(value), rtol=1e-10)
    assert res.converged is True and float(res.grad_norm) < 1e-3
    sigma = float(res.params.kernel.kernels[0].sigma)
    assert (sigma > 2.5) if with_prior else (sigma < 2.5), sigma


def test_lbfgs_evaluates_each_point_once(case):
    """One evaluation per point: the closure's call at the start of a
    step is served from the line search's last trial, a trial repeated
    after a step that could not move from the cache, and the final value
    and gradient too. The trace keeps its length
    after the optimizer's tolerances fire, its tail does not fall, and
    the result equals the autodiff route's to round-off."""
    seen = []

    def counting_prior(p):
        seen.append(tparams.to_array(p).detach().clone())
        return torch.zeros((), dtype=torch.float64)

    res = optimize(case["tinit"], case["x"], case["y"], steps=40,
                   log_prior=counting_prior)
    assert res.values.shape == (40,)
    assert all(not torch.equal(a, b) for i, a in enumerate(seen)
               for b in seen[:i])
    assert len(seen) < 2 * 40
    tail = res.values[10:].numpy()
    assert (np.diff(tail) >= -1e-9).all()
    auto = optimize(case["tinit"], case["x"], case["y"], steps=40,
                    method="autodiff")
    np.testing.assert_allclose(float(auto.value), float(res.value),
                               rtol=1e-10)


def test_lbfgs_in_float32_reaches_its_noise(case):
    """L-BFGS on float32 data: where the float32 values stop resolving a
    decrease, the approximate Wolfe test (in float64) goes on with the
    gradients, and the result is stationary to float32 noise: the float64
    gradient of the logML there, in unconstrained space, below 1e-4 (the
    float32 gradient's own error here is ~1e-5)."""
    x, y = case["x"].float(), case["y"].float()
    init = tparams.unflatten(case["tinit"], [
        t.float() for t in tparams.leaves(case["tinit"])])
    res = optimize(init, x, y, steps=25)
    assert res.converged and res.values.dtype == torch.float32
    p64 = tparams.unflatten(res.params, [t.double() for t in
                                         tparams.leaves(res.params)])
    bij = p64.bijectors()
    flat, unravel = tparams.unraveler(tparams.unconstrain(bij, p64))
    u = flat.requires_grad_()
    value = gp.log_marginal_likelihood(tparams.constrain(bij, unravel(u)),
                                       x.double(), y.double())
    (grad,) = torch.autograd.grad(value, u)
    assert float(grad.norm()) < 1e-4, grad


def test_template_cast_and_ignored_chunks(case):
    """float32 template leaves take the float64 data's type; chunk_steps
    changes nothing, bitwise."""
    t32 = tparams.unflatten(case["tinit"], [t.float() for t in
                                            tparams.leaves(case["tinit"])])
    a = optimize(t32, case["x"], case["y"], steps=6, optimizer="adam")
    b = optimize(t32, case["x"], case["y"], steps=6, optimizer="adam",
                 chunk_steps=4)
    assert all(t.dtype == torch.float64 for t in tparams.leaves(a.params))
    assert torch.equal(a.values, b.values)
    assert torch.equal(tparams.to_array(a.params), tparams.to_array(b.params))


def test_non_finite_objective(case):
    """A NaN log density gives +inf (a -inf value in the trace), its NaN
    gradient is zeroed and Adam goes on; L-BFGS against a wall of NaN
    (h > 2.5) backtracks in front of it and ends finite, better than the
    start."""
    calls = []

    def flaky(p):
        calls.append(1)
        return torch.tensor(float("nan") if len(calls) == 3 else 0.0,
                            dtype=torch.float64)

    res = optimize(case["tinit"], case["x"], case["y"], steps=12,
                   optimizer="adam", learning_rate=0.1, log_prior=flaky)
    vals = res.values.numpy()
    assert vals[2] == -np.inf and np.isfinite(np.delete(vals, 2)).all()
    assert float(res.value) > vals[0]

    def wall(p):
        h = p.kernel.kernels[0].h
        return torch.where(h > 2.5, float("nan"), 0.0).to(h.dtype)

    res = optimize(case["tinit"], case["x"], case["y"], steps=15,
                   log_prior=wall)
    assert torch.isfinite(res.values).all()
    assert float(res.params.kernel.kernels[0].h) <= 2.5
    assert float(res.value) > float(res.values[0]) + 10.0


def test_hybrid_and_iterative_routes():
    """method="hybrid": two calls with the same key bitwise alike, and a
    few Adam steps improve the exact logML; method="iterative": fresh
    probes per step from the key, repeatable, finite, improving."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(np.sort(rng.uniform(-10, 10, size=(64, 1)), axis=0))
    y = torch.as_tensor(2.0 * np.sin(x[:, 0].numpy())
                        + 0.4 * rng.normal(size=64))
    init = gt.Parameters(mean=gt.zero(), kernel=gt.se(0.8, 1.0, **F64)
                         + gt.white(1.5, **F64))
    exact0 = float(gp.log_marginal_likelihood(init, x, y))
    for kw in (dict(method="hybrid", n_probes=8, key=3),
               dict(method="iterative", n_probes=4, lanczos_iters=16,
                    key=torch.Generator().manual_seed(2))):
        state = kw["key"].get_state() if "lanczos_iters" in kw else None
        a = optimize(init, x, y, optimizer="adam", steps=8,
                     learning_rate=0.1, **kw)
        if state is not None:
            kw["key"].set_state(state)
        b = optimize(init, x, y, optimizer="adam", steps=8,
                     learning_rate=0.1, **kw)
        assert torch.equal(a.values, b.values), kw["method"]
        assert torch.isfinite(a.values).all()
        exact1 = float(gp.log_marginal_likelihood(a.params, x, y))
        assert exact1 > exact0 + 1.0, (kw["method"], exact0, exact1)


def test_stochastic_vjp_gradient_is_grads_times_cotangent():
    class Res:
        def __init__(self, p):
            self.value = torch.tensor(2.5, dtype=torch.float64)
            self.grads = tparams.unflatten(p, [torch.full_like(t, 1.5 + i)
                                               for i, t in enumerate(
                                                   tparams.leaves(p))])

    seen = []

    def run(p, gen):
        seen.append(gen)
        return Res(p)

    f = stochastic_log_density_vjp(run)
    p = gt.Parameters(mean=gt.zero(), kernel=gt.se(1.0, 2.0, **F64)
                      + gt.white(0.5, **F64))
    flat = [t.clone().requires_grad_() for t in tparams.leaves(p)]
    gen = torch.Generator().manual_seed(0)
    value = f(tparams.unflatten(p, flat), gen)
    grads = torch.autograd.grad(-3.0 * value, flat)
    assert float(value) == 2.5 and seen == [gen]
    assert [float(g) for g in grads] == [-4.5, -7.5, -10.5]
    with torch.no_grad():
        assert float(f(p, gen)) == 2.5


def test_optimize_log_density_finds_the_mode():
    """The generic core on independent Gamma(3, rate 2) densities over an
    SE kernel's two leaves: the mode (a - 1) / rate = 1 for both, by
    L-BFGS and by Adam."""
    g = Gamma(torch.tensor(3.0, dtype=torch.float64),
              torch.tensor(2.0, dtype=torch.float64))

    def log_density(k):
        return g.logpdf(k.h) + g.logpdf(k.sigma)

    template = gt.se(3.0, 0.4, **F64)
    for kw in (dict(steps=30), dict(optimizer="adam", steps=300,
                                    learning_rate=0.05)):
        res = optimize_log_density(template, log_density, **kw)
        np.testing.assert_allclose(tparams.to_array(res.params).numpy(),
                                   [1.0, 1.0], atol=1e-4)
        assert res.converged


def test_argument_checks(case):
    x, y, init = case["x"], case["y"], case["tinit"]
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimize(init, x, y, optimizer="sgd")
    with pytest.raises(ValueError, match="unknown method"):
        optimize(init, x, y, method="magic")
    with pytest.raises(ValueError, match="adam"):
        optimize(init, x, y, method="hybrid")
    with pytest.raises(ValueError, match="adam"):
        optimize(init, x, y, method="iterative")
    for method in ("analytic", "iterative"):
        with pytest.raises(NotImplementedError):
            optimize(init, x, y, method=method, optimizer="adam",
                     mesh=object())
    with pytest.raises(ValueError, match="step_keys"):
        optimize_log_density(init.kernel, lambda k: k.h, step_keys=[0, 1])
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimize_log_density(init.kernel, lambda k: k.h, optimizer="sgd")
