"""The sampler slice on the CPU in float64: bijectors, distributions, the
params transforms, the leapfrog, the accept ratio, the step-size update,
the mass estimate, the analytic VJP and the diagnostics against the JAX
package on shared inputs and noise (numpy); ``sample_hmc`` by recovery
and by its argument checks. No gpx sampler runs here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx import bijectors as jbij
from gpx import diagnostics as jdiag
from gpx import distributions as jdist
from gpx import params as jparams
from gpx.infer import dual_averaging as jda
from gpx.infer import hmc as jhmc
from gpx.models import gp as jgp
from gpx_torch import bijectors as tbij
from gpx_torch import diagnostics as tdiag
from gpx_torch import distributions as tdist
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy
from gpx_torch.infer import dual_averaging as tda
from gpx_torch.infer import hmc as thmc
from gpx_torch.infer import mcmc, sample_hmc, sample_hmc_log_density
from gpx_torch.models import gp
from tests.torch_parallel_ranks import one_rank_mesh

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _close(got, want, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol)


BIJECTORS = {
    "identity": (jbij.Identity(), tbij.Identity()),
    "below": (jbij.BoundedBelow(0.3), tbij.BoundedBelow(0.3)),
    "above": (jbij.BoundedAbove(2.0), tbij.BoundedAbove(2.0)),
    "bounded": (jbij.Bounded(-1.0, 3.0), tbij.Bounded(-1.0, 3.0)),
    "softplus": (jbij.Softplus(), tbij.Softplus()),
}


@pytest.mark.parametrize("name", list(BIJECTORS))
def test_bijectors_match_gpx(rng, name):
    jb, tb = BIJECTORS[name]
    u = rng.normal(size=7) * 3.0
    c = np.asarray(jb.forward(jnp.asarray(u)))
    _close(tb.forward(_t(u)), c)
    _close(tb.inverse(_t(c)), np.asarray(jb.inverse(jnp.asarray(c))),
           rtol=1e-10)
    _close(tb.log_det_jacobian(_t(u)),
           np.asarray(jb.log_det_jacobian(jnp.asarray(u))))
    assert tb == type(tb)(*tb.__dict__.values()) and hash(tb) == hash(
        type(tb)(*tb.__dict__.values()))


def test_bijector_helpers_match_gpx(rng):
    x = rng.normal(size=9) * 30.0
    p = rng.uniform(0.01, 0.99, size=9)
    _close(tbij.logistic(_t(x)), np.asarray(jbij.logistic(jnp.asarray(x))))
    _close(tbij.softplus(_t(x)), np.asarray(jbij.softplus(jnp.asarray(x))))
    _close(tbij.logit(_t(p)), np.asarray(jbij.logit(jnp.asarray(p))))


def _dists():
    l = np.array([[1.2, 0.0, 0.0], [0.3, 0.8, 0.0], [-0.4, 0.5, 1.1]])
    return [
        (jdist.Normal(jnp.asarray(0.4), jnp.asarray(1.7)),
         tdist.Normal(_t(0.4), _t(1.7)), (-3.0, 3.0)),
        (jdist.Gamma(jnp.asarray(2.0), jnp.asarray(0.5)),
         tdist.Gamma(_t(2.0), _t(0.5)), (-1.0, 9.0)),
        (jdist.InverseGamma(jnp.asarray(3.0), jnp.asarray(2.0)),
         tdist.InverseGamma(_t(3.0), _t(2.0)), (0.1, 5.0)),
        (jdist.Uniform(jnp.asarray(-1.0), jnp.asarray(2.5)),
         tdist.Uniform(_t(-1.0), _t(2.5)), (-2.0, 3.0)),
        (jdist.StudentT(jnp.asarray(4.5), jnp.asarray(0.3), jnp.asarray(2.0)),
         tdist.StudentT(_t(4.5), _t(0.3), _t(2.0)), (-6.0, 6.0)),
        (jdist.MultivariateNormal(jnp.asarray([0.1, -0.2, 0.3]), jnp.asarray(l)),
         tdist.MultivariateNormal(_t([0.1, -0.2, 0.3]), _t(l)), None),
    ]


@pytest.mark.parametrize("i", range(6))
def test_distributions_logpdf_match_gpx(rng, i):
    jd, td, span = _dists()[i]
    if span is None:  # the MVN: one 3-vector at a time
        for v in rng.normal(size=(4, 3)):
            _close(td.logpdf(_t(v)), float(jd.logpdf(jnp.asarray(v))))
        return
    x = np.linspace(*span, 23)
    _close(td.logpdf(_t(x)), np.asarray(jd.logpdf(jnp.asarray(x))))
    gx = np.linspace(0.5, 2.0, 5)
    if not isinstance(td, tdist.Uniform):
        _close(tdist.grad_logpdf(td, gx),
               np.asarray(jdist.grad_logpdf(jd, gx)), rtol=1e-10)


def test_distribution_samples_and_ppf():
    """``sample`` draws from an explicit generator: repeatable by seed, with
    the distribution's mean; Normal's inverse CDF matches gpx's."""
    draws = {}
    for td, mean in ((tdist.Normal(_t(0.4), _t(1.7)), 0.4),
                     (tdist.Gamma(_t(2.0), _t(0.5)), 4.0),
                     (tdist.InverseGamma(_t(3.0), _t(2.0)), 1.0),
                     (tdist.Uniform(_t(-1.0), _t(2.5)), 0.75),
                     (tdist.StudentT(_t(4.5), _t(0.3), _t(2.0)), 0.3)):
        a = td.sample(torch.Generator().manual_seed(5), (20000,))
        b = td.sample(torch.Generator().manual_seed(5), 20000)
        assert torch.equal(a, b) and a.shape == (20000,)
        draws[type(td).__name__] = float(a.mean())
        assert abs(float(a.mean()) - mean) < 0.06 * max(1.0, mean), draws
    mvn = tdist.MultivariateNormal.from_cov(_t([1.0, 2.0]),
                                            _t([[2.0, 0.5], [0.5, 1.0]]))
    s = mvn.sample(torch.Generator().manual_seed(1), (20000,))
    assert s.shape == (20000, 2)
    assert torch.allclose(torch.cov(s.T), _t([[2.0, 0.5], [0.5, 1.0]]),
                          atol=0.08)
    q = np.array([0.025, 0.5, 0.9])
    _close(tdist.Normal(_t(0.4), _t(1.7)).ppf(q),
           np.asarray(jdist.Normal(jnp.asarray(0.4), jnp.asarray(1.7)).ppf(q)),
           rtol=1e-10)


def _tree_pair():
    """gpx's and the port's trees with Matern, Periodic, an Ard and a Plane
    mean (an Identity bijector on a vector leaf)."""
    jk = (gpx.se(3.0, 5.5) * gpx.periodic(1.2, 2.5, 0.8)
          + gpx.ard(gpx.matern(2.0, 2.5, 1.0), [0.7, 2.3])
          + gpx.white(0.5))
    jp = gpx.Parameters(mean=gpx.plane([0.3, -0.2, 0.1]), kernel=jk)
    tk = (gt.se(1.0, 1.0, **F64) * gt.periodic(1.0, 1.0, 1.0, **F64)
          + gt.ard(gt.matern(1.0, 2.5, 1.0, **F64), [1.0, 1.0], **F64)
          + gt.white(1.0, **F64))
    tp = params_from_numpy(gt.Parameters(mean=gt.plane([0.0, 0.0, 0.0], **F64),
                                         kernel=tk),
                           jax.tree_util.tree_leaves(jp))
    return jp, tp


def test_params_transforms_match_gpx():
    jp, tp = _tree_pair()
    jb, tb = jp.bijectors(), tp.bijectors()
    assert [repr(b) for b in tparams.leaves(tb)] == [
        repr(b) for b in jax.tree_util.tree_leaves(
            jb, is_leaf=lambda v: isinstance(v, jbij.Bijector))]
    ju = jparams.unconstrain(jb, jp)
    tu = tparams.unconstrain(tb, tp)
    flat_j = np.asarray(jparams.to_array(ju))
    _close(tparams.to_array(tu), flat_j)
    _close(tparams.log_det_jacobian(tb, tu),
           float(jparams.log_det_jacobian(jb, ju)))
    back = tparams.constrain(tb, tu)
    _close(tparams.to_array(back), np.asarray(jparams.to_array(jp)))
    flat0, unravel = tparams.unraveler(tu)
    _close(flat0, flat_j)
    _close(tparams.to_array(unravel(flat0 + 0.5)), flat_j + 0.5)
    _close(tparams.to_array(tparams.from_array(tu, flat0)), flat_j)
    assert tparams.names(tp) == jparams.names(jp)
    assert tparams.to_dict(tp) == pytest.approx(jparams.to_dict(jp), rel=1e-15)


def test_kernel_evaluate_and_variance_match_gpx(rng):
    jp, tp = _tree_pair()
    d = rng.uniform(0, 4, size=11)
    for jk, tk in ((jp.kernel.kernels[0], tp.kernel.kernels[0]),
                   (jp.kernel.kernels[2], tp.kernel.kernels[2])):
        _close(tk.evaluate(_t(d)), np.asarray(jk.evaluate(jnp.asarray(d))))
        _close(tk.variance(5), np.asarray(jk.variance(5)))
        assert tk.variance(5).shape == (5,)


def _target():
    """A non-Gaussian log-density in both packages (its gradient by each
    package's autodiff)."""
    a = np.array([[2.0, 0.4, 0.0], [0.4, 1.0, -0.3], [0.0, -0.3, 0.5]])

    def jfn(q):
        return -0.5 * q @ jnp.asarray(a) @ q - 0.1 * jnp.sum(q ** 4)

    def tfn(q):
        return -0.5 * q @ _t(a) @ q - 0.1 * torch.sum(q ** 4)

    return jfn, tfn


def test_leapfrog_and_acceptance_match_gpx(rng):
    jfn, tfn = _target()
    q, p = rng.normal(size=3), rng.normal(size=3)
    inv_mass = np.array([1.0, 0.5, 2.0])
    jvag = jax.value_and_grad(jfn)
    tvag = thmc.value_and_grad(tfn)
    g = np.asarray(jvag(jnp.asarray(q))[1])
    _close(tvag(_t(q))[1], g)
    want = jhmc.leapfrog(jvag, jnp.asarray(q), jnp.asarray(p), jnp.asarray(g),
                         0.17, 7, jnp.asarray(inv_mass))
    got = thmc.leapfrog(tvag, _t(q), _t(p), _t(g), 0.17, 7, _t(inv_mass))
    for a, b in zip(got, want):
        _close(a, np.asarray(b))
    lp0 = float(jfn(jnp.asarray(q)))
    for lp1 in (float(want[3]), float("nan")):
        _close(thmc.log_acceptance(_t(lp1), got[1], _t(lp0), _t(p),
                                   _t(inv_mass)),
               float(jhmc.log_acceptance(jnp.asarray(lp1), want[1],
                                         jnp.asarray(lp0), jnp.asarray(p),
                                         jnp.asarray(inv_mass))))


def test_step_size_update_and_mass_match_gpx(rng):
    s_j = jda.DAState(jnp.asarray(-1.0), jnp.asarray(0.0), jnp.asarray(0.0))
    s_t = tda.DAState(_t(-1.0), _t(0.0), _t(0.0))
    mu = np.log(10.0 * 0.37)
    for m, acc in enumerate(rng.uniform(0, 1, size=12), start=1):
        s_j = jda.update_eps(jnp.asarray(m), mu, 0.65, jnp.asarray(acc), s_j)
        s_t = tda.update_eps(m, mu, 0.65, _t(acc), s_t)
        for a, b in zip(s_t, s_j):
            _close(a, float(b))
    draws = rng.normal(size=(40, 3)) * np.array([0.1, 1.0, 3.0])
    # gpx's window warmup forms its mass inline: 1 / (var + 1e-6)
    _close(tda.mass_from_draws(_t(draws)),
           np.asarray(1.0 / (jnp.var(jnp.asarray(draws), axis=0) + 1e-6)))


def test_mh_kernel_and_chain_runner():
    """The random-walk MH kernel through base.sample (burn-in, thinning)
    on N(1, 0.5^2): the chain's mean and sd, its accept rate, and the
    kept draws' count; a NaN log-density rejects."""
    from gpx_torch.infer import base, mh

    def logpost(q):
        return -0.5 * torch.sum(((q - 1.0) / 0.5) ** 2)

    step = mh.kernel(logpost, mh.gaussian_random_walk(0.8))
    res = base.sample(step, mh.init(_t([0.0]), logpost),
                      torch.Generator().manual_seed(2), 3000, burn_in=100,
                      thin=2, collect=lambda s: s.position)
    assert res.samples.shape == (3000, 1)
    assert abs(float(res.samples.mean()) - 1.0) < 0.06
    assert abs(float(res.samples.std()) - 0.5) < 0.05
    assert 0.3 < float(res.accept_rate) < 0.8
    nan_step = mh.kernel(lambda q: torch.tensor(float("nan"),
                                                dtype=torch.float64),
                         mh.gaussian_random_walk(0.8))
    s = nan_step(torch.Generator().manual_seed(0),
                 mh.init(_t([0.0]), logpost))
    assert float(s.position) == 0.0 and int(s.accepted) == 0


def _gp_pair(rng, n):
    jp = gpx.Parameters(mean=gpx.zero(), kernel=gpx.se(3.0, 5.5) + gpx.white(0.5))
    tp = params_from_numpy(gt.Parameters(
        mean=gt.zero(), kernel=gt.se(1.0, 1.0, **F64) + gt.white(1.0, **F64)),
        jax.tree_util.tree_leaves(jp))
    x = rng.uniform(-10, 10, size=(n, 1))
    return jp, tp, x, rng.normal(size=n)


def test_analytic_vjp_matches_gpx(rng):
    """The analytic VJP's autograd gradient against gpx's
    logml_value_and_grad; an undifferentiated call is the plain Cholesky
    value."""
    jp, tp, x, y = _gp_pair(rng, 60)
    jv, jg = jax.jit(lambda p: jgp.logml_value_and_grad(
        p, jnp.asarray(x), jnp.asarray(y)))(jp)
    ll = gp.log_marginal_likelihood_analytic_vjp(torch.as_tensor(x),
                                                 torch.as_tensor(y))
    flat = [t.clone().requires_grad_() for t in tparams.leaves(tp)]
    value = ll(tparams.unflatten(tp, flat))
    grads = torch.autograd.grad(3.0 * value, flat)
    _close(float(value.detach()), float(jv), rtol=1e-10)
    _close([float(g) / 3.0 for g in grads],
           [float(g) for g in jax.tree_util.tree_leaves(jg)], rtol=1e-8)
    with torch.no_grad():
        primal = ll(tp)
    assert torch.equal(primal, gp.log_marginal_likelihood(
        tp, torch.as_tensor(x), torch.as_tensor(y)))


def test_hybrid_vjp_is_deterministic(rng):
    """The hybrid VJP draws its probes once from a copy of the key: its
    gradient is method="hybrid"'s with that key, every call alike, and
    the caller's generator does not advance."""
    _, tp, x, y = _gp_pair(rng, 64)
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    key = torch.Generator().manual_seed(3)
    state = key.get_state()
    ll = gp.log_marginal_likelihood_hybrid_vjp(x, y, probes=8, probe_key=key)
    assert torch.equal(key.get_state(), state)
    want_v, want_g = gp.logml_value_and_grad(
        tp, x, y, method="hybrid", probes=8,
        probe_key=torch.Generator().manual_seed(3))
    for _ in range(2):
        flat = [t.clone().requires_grad_() for t in tparams.leaves(tp)]
        value = ll(tparams.unflatten(tp, flat))
        grads = torch.autograd.grad(value, flat)
        assert torch.equal(value, want_v)
        assert all(torch.equal(a, b) for a, b in
                   zip(grads, tparams.leaves(want_g)))


def _recovery_case():
    """gpx's test_fast_warmup_end_to_end_gp case: 24 points drawn from
    SE(3, 5.5) + White(0.5), Gamma(2, 0.5) priors."""
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.uniform(-10, 10, size=(24, 1)))
    truth = gt.Parameters(mean=gt.zero(),
                          kernel=gt.se(3.0, 5.5, **F64) + gt.white(0.5, **F64))
    k = truth.kernel.gram(x, nugget=1e-3)
    y = torch.linalg.cholesky(k) @ torch.as_tensor(rng.normal(size=24))
    pr = tdist.Gamma(_t(2.0), _t(0.5))

    def log_prior(p):
        a, b = p.kernel.kernels
        return pr.logpdf(a.h) + pr.logpdf(a.sigma) + pr.logpdf(b.sigma)

    return x, y, truth, log_prior


def test_sample_hmc_recovers():
    """As gpx's test_fast_warmup_end_to_end_gp (2 chains, analytic
    gradients with fast_warmup, adaptive eps below n = 2048): finite draws
    and every chain's accept rate above 0.3; the output's shapes and
    names."""
    x, y, truth, log_prior = _recovery_case()
    post = sample_hmc(13, x, y, truth, log_prior, 60, n_chains=2, burn_in=10,
                      l=5, warmup_iters=40, analytic_gradients=True,
                      fast_warmup=True)
    assert post.flat.shape == (2, 60, 3)
    assert post.names == tparams.names(truth)
    assert bool(torch.isfinite(post.flat).all())
    assert bool((post.accept_rate > 0.3).all())
    assert post.extras["eps"].shape == (2,)
    h = post.params.kernel.kernels[0].h
    assert h.shape == (2, 60) and torch.equal(h, post.flat[..., 0])


def test_sample_hmc_hybrid_and_ignored_options():
    """gradients="hybrid" runs; chunk_iters and program_cache change
    nothing; the same seed gives the same draws."""
    x, y, truth, log_prior = _recovery_case()
    kw = dict(n_chains=1, l=3, eps=0.2, gradients="hybrid", probes=8)
    a = sample_hmc(5, x, y, truth, log_prior, 6, **kw)
    b = sample_hmc(torch.Generator().manual_seed(5), x, y, truth, log_prior,
                   6, chunk_iters=2, program_cache={}, **kw)
    assert bool(torch.isfinite(a.flat).all())
    assert torch.equal(a.flat, b.flat)


def test_sample_hmc_argument_checks():
    x, y, truth, log_prior = _recovery_case()
    run = lambda **kw: sample_hmc(0, x, y, truth, log_prior, 2,  # noqa: E731
                                  n_chains=1, **kw)
    with pytest.raises(ValueError, match="unknown gradients"):
        run(gradients="bogus")
    with pytest.raises(ValueError, match="single-chip"):
        run(gradients="hybrid", fast_warmup=True)
    with pytest.raises(ValueError, match="requires analytic_gradients"):
        run(fast_warmup=True)
    with pytest.raises(ValueError, match="adapt_mass"):
        run(eps=0.1, adapt_mass=True)
    with pytest.raises(ValueError, match="chunk_iters"):
        run(chunk_iters=0)
    with pytest.raises(ValueError, match="combine it with neither"):
        run(mesh=object(), analytic_gradients=True)
    # mesh= (a one-rank gloo mesh): the same chain as without it
    with one_rank_mesh() as mesh:
        got = run(mesh=mesh, eps=0.1, l=3, panel=24)
    np.testing.assert_allclose(got.flat.numpy(), run(eps=0.1, l=3).flat.numpy(),
                               rtol=1e-9)
    with pytest.raises(ValueError, match="nugget-escalation"):
        mcmc._gp_log_density(x, y, log_prior, 1e-3, safe=True,
                             analytic_gradients=True)
    with pytest.raises(ValueError, match="exclusive"):
        sample_hmc_log_density(0, truth, log_prior, 2, warmup_log_density=log_prior,
                               force_log_density=log_prior)
    # the configuration gpx measured to freeze the chains
    x_big = torch.linspace(-10.0, 10.0, 2048, dtype=torch.float64)[:, None]
    with pytest.raises(ValueError, match="measured-broken"):
        sample_hmc(13, x_big, torch.zeros(2048, dtype=torch.float64), truth,
                   log_prior, 10, n_chains=1, analytic_gradients=True,
                   fast_warmup=True)


def test_diagnostics_match_gpx(rng):
    draws = (np.cumsum(rng.normal(size=(3, 150, 2)), axis=1) * 0.1
             + rng.normal(size=(3, 150, 2)))
    _close(tdiag.acf(draws[0, :, 0], 12), np.asarray(jdiag.acf(draws[0, :, 0], 12)),
           rtol=1e-10, atol=1e-12)
    assert tdiag.autocorrelation(draws[1, :, 1], 3) == pytest.approx(
        jdiag.autocorrelation(draws[1, :, 1], 3), rel=1e-10)
    _close(float(tdiag.ess(draws[0, :, 1])), float(jdiag.ess(draws[0, :, 1])),
           rtol=1e-10)
    _close(float(tdiag.split_rhat(draws[:, :, 0])),
           float(jdiag.split_rhat(draws[:, :, 0])), rtol=1e-10)
    # gpx's summary is one jitted program (seconds to compile): the port's
    # is held statistic by statistic, against the functions held above
    got = tdiag.summary(torch.as_tensor(draws), ["a", "b"])
    pooled = draws.reshape(-1, 2)
    for j, name in enumerate(("a", "b")):
        row = got[name]
        _close([row["mean"], row["sd"], row["q5"], row["median"], row["q95"]],
               [pooled[:, j].mean(), pooled[:, j].std(ddof=1),
                *np.percentile(pooled[:, j], [5.0, 50.0, 95.0])], rtol=1e-10)
        _close(row["ess"], sum(float(tdiag.ess(draws[c, :, j]))
                               for c in range(3)), rtol=1e-12)
        _close(row["rhat"], float(tdiag.split_rhat(draws[:, :, j])),
               rtol=1e-12)
    assert tdiag.format_summary(got) == jdiag.format_summary(got)
