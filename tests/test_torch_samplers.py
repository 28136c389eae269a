"""NUTS, eHMC, MH and MH-within-Gibbs on the CPU in float64: the
deterministic pieces against the JAX package on shared inputs and noise
(``ehmc.is_u_turn``, ``means.design_matrix``, the Gibbs conditionals),
the samplers by recovery (the two packages' generators differ): the
generic cores on a Gamma target and NUTS on a Gaussian, as
tests/test_generic_samplers.py, and GP recovery for each GP entry
point, as tests/test_mcmc_gp.py, at small draw counts. No gpx sampler
runs here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx import distributions as jdist
from gpx import means as jmeans
from gpx.infer import ehmc as jehmc
from gpx.infer import gibbs as jgibbs
from gpx.ops import chol as jchol
from gpx_torch import distributions as tdist
from gpx_torch import means as tmeans
from gpx_torch import params as tparams
from gpx_torch.infer import (
    base, ehmc, gibbs, hmc, nuts, sample_ehmc, sample_ehmc_log_density,
    sample_mh, sample_mh_log_density, sample_mh_within_gibbs, sample_nuts,
    sample_nuts_log_density,
)

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


def _gpx_oracles(u_turn_args, x_d, y, fx, x_p, y_p, z):
    """gpx's deterministic pieces in one program: ``is_u_turn`` on each
    row, ``design_matrix``, ``sample_precision_y``'s posterior (its draw
    discarded) and ``sample_plane``'s draw ``mean + L_prec^-T z`` with
    the conditional formed from gpx's ops.chol functions (SE(1.5, 2) +
    White(0.3), prior N(0.5, 2^2), nugget 1e-6)."""
    turns = jax.vmap(jehmc.is_u_turn)(*u_turn_args)
    _, post = jgibbs.sample_precision_y(
        jax.random.PRNGKey(0), jdist.Gamma(jnp.asarray(2.0), jnp.asarray(0.5)),
        y, fx)
    kernel = gpx.se(1.5, 2.0) + gpx.white(0.3)
    xd = jmeans.design_matrix(x_p)
    l = jchol.cholesky(kernel.gram(x_p, nugget=1e-6))
    w, u = jchol.forward_solve(l, xd), jchol.forward_solve(l, y_p)
    prec = w.T @ w + jnp.eye(3) / 4.0
    l_prec = jchol.cholesky(prec)
    mean = jchol.back_solve(l_prec.T, jchol.forward_solve(
        l_prec, jnp.full(3, 0.5 / 4.0) + w.T @ u))
    return (turns, jmeans.design_matrix(x_d), post.concentration, post.rate,
            mean + jchol.back_solve(l_prec.T, z))


def test_deterministic_pieces_match_gpx(rng):
    """Against gpx on shared inputs: ``ehmc.is_u_turn`` ((q - q0) . p <
    0, a NaN counting as a U-turn), ``means.design_matrix``,
    ``gibbs.sample_precision_y``'s posterior (to 1e-14), and
    ``gibbs.sample_plane``: the draw is ``mean + L_prec^-T z``, so with
    the port's normal draw replayed it equals gpx's conditional mean and
    covariance root to 1e-10. A Zero mean passes ``sample_mean``."""
    q0, q, p = rng.normal(size=(3, 8, 4))
    q[3, 1] = np.nan
    x_d = rng.normal(size=(7, 3))
    y, fx = rng.normal(size=30), rng.normal(size=30)
    x_p = np.sort(rng.uniform(-5, 5, size=(30, 2)), axis=0)
    y_p = 1.0 + x_p @ np.array([0.4, -0.3]) + rng.normal(size=30)
    tp = gt.Parameters(mean=gt.plane([0.0, 0.0, 0.0], **F64),
                       kernel=gt.se(1.5, 2.0, **F64) + gt.white(0.3, **F64))
    beta = gibbs.sample_plane(torch.Generator().manual_seed(4),
                              tdist.Normal(_t(0.5), _t(2.0)), _t(x_p),
                              _t(y_p), tp).beta.numpy()
    z = torch.randn(3, generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64).numpy()
    draw, post = gibbs.sample_precision_y(
        torch.Generator().manual_seed(0), tdist.Gamma(_t(2.0), _t(0.5)),
        _t(y), _t(fx))
    want = jax.jit(_gpx_oracles, compiler_options=_FAST_COMPILE)(
        (jnp.asarray(q0), jnp.asarray(q), jnp.asarray(p)), jnp.asarray(x_d),
        jnp.asarray(y), jnp.asarray(fx), jnp.asarray(x_p), jnp.asarray(y_p),
        jnp.asarray(z))
    turns = [bool(ehmc.is_u_turn(_t(a), _t(b), _t(c)))
             for a, b, c in zip(q0, q, p)]
    assert turns == np.asarray(want[0]).tolist() and turns[3]
    assert 0 < sum(turns) < 8
    np.testing.assert_array_equal(tmeans.design_matrix(_t(x_d)).numpy(),
                                  np.asarray(want[1]))
    np.testing.assert_allclose(
        [float(post.concentration), float(post.rate)],
        [float(want[2]), float(want[3])], rtol=1e-14)
    assert float(draw) > 0
    np.testing.assert_allclose(beta, np.asarray(want[4]), rtol=1e-10)
    tz = gt.Parameters(mean=gt.zero(), kernel=tp.kernel)
    assert gibbs.sample_mean(None, None, _t(x_p), _t(y_p), tz) is tz


def _gamma_density(k):
    """Independent Gamma(3, rate 2) on both SE leaves (mean 1.5, variance
    0.75), unnormalized: (a - 1) log v - rate v."""
    return 2.0 * (torch.log(k.h) + torch.log(k.sigma)) - 2.0 * (k.h + k.sigma)


@pytest.mark.parametrize("sampler", ["mh", "nuts", "ehmc"])
def test_generic_samplers_recover_gamma_target(sampler):
    """The generic cores on the two Gamma(3, 2) marginals, as
    test_generic_samplers.py, at fewer draws (MH 2 x 600, NUTS 1 x 200,
    eHMC 1 x 200): the pooled mean within 0.25 and variance within 0.45,
    about three Monte Carlo standard errors at those draws (gpx's test:
    0.12 and 0.25 at 1500 or more)."""
    template = gt.se(1.0, 1.0, **F64)
    if sampler == "mh":
        post = sample_mh_log_density(0, template, _gamma_density, 600,
                                     n_chains=2, burn_in=100,
                                     proposal_scale=0.6)
        assert (post.accept_rate > 0.1).all()
    elif sampler == "nuts":
        post = sample_nuts_log_density(1, template, _gamma_density, 200,
                                       n_chains=1, warmup_iters=15,
                                       max_depth=6)
        depth = post.extras["depth"]
        assert depth.shape == (1, 200)
        assert 1 <= int(depth.min()) and int(depth.max()) <= 6
        assert (post.accept_rate > 0.5).all()
    else:
        post = sample_ehmc_log_density(2, template, _gamma_density, 200,
                                       n_chains=1, warmup_iters=15, k=15,
                                       l0=3, l_max=8)
        lengths = post.extras["lengths"]
        assert lengths.shape == (1, 15)
        assert 1 <= int(lengths.min()) and int(lengths.max()) <= 8
        assert (post.accept_rate > 0.5).all()
    assert post.names == ["h", "sigma"]
    pooled = post.flat.reshape(-1, 2).numpy()
    np.testing.assert_allclose(pooled.mean(0), [1.5, 1.5], atol=0.25)
    np.testing.assert_allclose(pooled.var(0), [0.75, 0.75], atol=0.45)


def test_nuts_gaussian_within_monte_carlo_error():
    """nuts.sample on a 2-D Gaussian (sds 0.5 and 2, correlation 0.6) at
    a fixed step: the mean within about four Monte Carlo standard errors
    of 250 draws and the sds within 20%; depth never past max_depth (3
    here, and reached: the cap stops the doubling); a NaN log density
    moves nothing."""
    cov = np.array([[0.25, 0.6], [0.6, 4.0]])
    prec = _t(np.linalg.inv(cov))

    def logpost(q):
        return -0.5 * q @ prec @ q

    res, extras = nuts.sample(logpost, _t([1.0, -1.0]),
                              torch.Generator().manual_seed(5), 250,
                              eps=0.3, max_depth=3, burn_in=20,
                              collect=lambda s: (s.position, s.depth))
    q, depth = res.samples
    q = q.numpy()
    assert abs(q[:, 0].mean()) < 0.15 and abs(q[:, 1].mean()) < 0.6
    np.testing.assert_allclose(q.std(0), [0.5, 2.0], rtol=0.2)
    assert int(depth.max()) == 3 and int(depth.min()) >= 1
    assert float(extras["eps"]) == 0.3 and float(res.accept_rate) > 0.9

    nan_step = nuts.kernel(lambda q: torch.sum(q) * float("nan"), 0.1,
                           max_depth=3)
    state = nuts.NUTSState(_t([0.5, 0.5]), _t(-1.0), _t([0.0, 0.0]),
                           torch.zeros((), dtype=torch.int32),
                           torch.zeros((), dtype=torch.int32))
    out = nan_step(torch.Generator().manual_seed(0), state)
    assert torch.equal(out.position, state.position)
    assert int(out.accepted) == 0 and int(out.depth) == 1


def test_ehmc_longest_batch_step():
    """On a standard Gaussian a trajectory turns within one period (2 pi /
    eps leapfrogs); the proposal is the l0-th state; a trajectory that
    never turns reports l_max."""
    def logpost(q):
        return -0.5 * torch.sum(q * q)

    vag = hmc.value_and_grad(logpost)
    state = hmc.init(_t([1.0, 0.0]), logpost)
    gen = torch.Generator().manual_seed(3)
    lengths = [ehmc.longest_batch_step(gen, state, vag, 0.1, 4, 200, None)[1]
               for _ in range(8)]
    assert all(1 <= n <= 63 for n in lengths), lengths
    _, n = ehmc.longest_batch_step(gen, state, vag, 0.001, 4, 20, None)
    assert n == 20


def test_sample_chains_broadcasts_and_stacks():
    """base.sample_chains: one state for every chain or a stacked one,
    each chain on its own generator, results (chains, draws, ...)."""
    def step(gen, s):
        return s + torch.randn(s.shape, generator=gen, dtype=s.dtype)

    res = base.sample_chains(step, _t([0.0, 1.0]), 3, 5, 3)
    assert res.samples.shape == (3, 5, 2) and res.final_state.shape == (3, 2)
    assert not torch.equal(res.samples[0], res.samples[1])
    stacked = base.sample_chains(step, _t([[0.0, 1.0], [5.0, 5.0]]), 3, 5, 2,
                                 sequential=True)
    assert torch.equal(stacked.samples[0], res.samples[0])
    assert float(stacked.samples[1, 0, 0]) > 2.0


def _simulate(seed, n, truth=None):
    """tests/test_mcmc_gp.py's model, SE(3, 5.5) + White(0.5) unless
    ``truth`` is given, drawn at n sorted points on [-10, 10]."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(np.sort(rng.uniform(-10, 10, size=(n, 1)), axis=0))
    if truth is None:
        truth = gt.Parameters(mean=gt.zero(), kernel=gt.se(3.0, 5.5, **F64)
                              + gt.white(0.5, **F64))
    k = truth.kernel.gram(x, nugget=1e-3)
    y = truth.mean(x) + torch.linalg.cholesky(k) @ _t(rng.normal(size=n))
    return x, y, truth


def _log_prior(p):
    pr = tdist.Gamma(_t(2.0), _t(0.5))
    k0, k1 = p.kernel.kernels
    return pr.logpdf(k0.h) + pr.logpdf(k0.sigma) + pr.logpdf(k1.sigma)


@pytest.mark.parametrize("sampler", ["nuts", "mh", "ehmc"])
def test_gp_samplers_recover(sampler):
    """GP recovery as tests/test_mcmc_gp.py (its data model and priors, 24
    points, a template away from the truth): every true value inside the
    pooled central 98%; eHMC with a small k; shapes and extras. (The
    analytic VJP the card's NUTS takes is held in test_torch_infer.py.)"""
    x, y, _ = _simulate(3, 24)
    template = gt.Parameters(mean=gt.zero(), kernel=gt.se(2.0, 2.0, **F64)
                             + gt.white(1.0, **F64))
    if sampler == "nuts":
        post = sample_nuts(8, x, y, template, _log_prior, 40, n_chains=1,
                           warmup_iters=8, max_depth=3)
        assert post.extras["depth"].shape == (1, 40)
        assert (post.accept_rate > 0.5).all()
    elif sampler == "mh":
        post = sample_mh(1, x, y, template, _log_prior, 200, n_chains=2,
                         burn_in=60, proposal_scale=0.3)
        assert (post.accept_rate > 0.05).all()
    else:
        post = sample_ehmc(2, x, y, template, _log_prior, 50, n_chains=1,
                           warmup_iters=10, k=8, l0=3, l_max=12)
        assert post.extras["eps"].shape == (1,)
        assert post.extras["lengths"].shape == (1, 8)
        assert (post.accept_rate > 0.3).all()
    assert bool(torch.isfinite(post.flat).all())
    assert post.names == tparams.names(template)
    pooled = post.flat.reshape(-1, 3).numpy()
    lo, hi = np.percentile(pooled, [1.0, 99.0], axis=0)
    for v, a, b in zip((3.0, 5.5, 0.5), lo, hi):
        assert a < v < b, (v, a, b)


def test_mh_within_gibbs_recovers_plane():
    """tests/test_mcmc_gp.py's Plane-mean case at 30 points: the plane's
    coefficients recovered (medians within its bounds), every chain
    accepting, the draws packaged per leaf."""
    truth = gt.Parameters(mean=gt.plane([2.0, 0.4], **F64),
                          kernel=gt.se(1.5, 3.0, **F64) + gt.white(0.3, **F64))
    x, y, _ = _simulate(4, 30, truth)
    template = gt.Parameters(mean=gt.plane([0.0, 0.0], **F64),
                             kernel=gt.se(1.0, 2.0, **F64)
                             + gt.white(0.5, **F64))

    def log_prior_kernel(k):
        return _log_prior(gt.Parameters(mean=gt.zero(), kernel=k))

    post = sample_mh_within_gibbs(5, x, y, template, log_prior_kernel,
                                  tdist.Normal(_t(0.0), _t(5.0)), 80,
                                  n_chains=2, burn_in=40,
                                  proposal_scale=0.12)
    assert post.flat.shape == (2, 80, 5)
    assert post.params.mean.beta.shape == (2, 80, 2)
    pooled = post.flat.reshape(-1, 5).numpy()
    b0 = pooled[:, post.names.index("mean.beta_0")]
    b1 = pooled[:, post.names.index("mean.beta_1")]
    assert abs(np.median(b0) - 2.0) < 1.5 and abs(np.median(b1) - 0.4) < 0.3
    assert (post.accept_rate > 0.02).all()


def test_sampler_argument_checks():
    x, y, truth = _simulate(3, 16)
    with pytest.raises(ValueError, match="adapt_mass"):
        sample_nuts(0, x, y, truth, _log_prior, 2, eps=0.1, adapt_mass=True,
                    n_chains=1)
    with pytest.raises(ValueError, match="requires analytic_gradients"):
        sample_nuts(0, x, y, truth, _log_prior, 2, fast_warmup=True,
                    n_chains=1)
    for fn in (sample_mh, sample_nuts, sample_ehmc):
        with pytest.raises(NotImplementedError):
            fn(0, x, y, truth, _log_prior, 2, mesh=object())
    with pytest.raises(ValueError, match="combine it with neither"):
        sample_mh(0, x, y, truth, _log_prior, 2, safe=True, mesh=object())
    # safe=True: the nugget-escalation route rejects what it cannot factor
    post = sample_mh(6, x, y, truth, _log_prior, 20, n_chains=2, safe=True)
    assert bool(torch.isfinite(post.flat).all())
