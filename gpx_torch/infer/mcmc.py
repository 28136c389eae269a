"""GP hyperparameter inference entry points — the port of
``gpx/infer/mcmc.py``: random-walk MH, HMC, NUTS, eHMC and
MH-within-Gibbs (the reference's
``KernelParameters.sample/sampleHmc/sampleEhmc``, KernelParameters.scala:
121-246, and ``Mcmc.sample``, Mcmc.scala:63-76), each with a
bring-your-own-likelihood core ``sample_*_log_density``.

Differences from the JAX package, by design of the port:
- ``key`` is a ``torch.Generator`` or an int seed. Seeds drawn from it
  start the inits, (for HMC) the warmups and the sampling; each chain gets
  its own generators, seeded from those, on the parameters' device.
- Chains run back to back (gpx's ``sequential=True``): one fused
  evaluation already fills the card. ``sequential=`` is accepted and
  ignored where gpx takes it.
- ``chunk_iters=`` and ``program_cache=`` bound and cache compiled XLA
  programs; the port compiles nothing, so they are accepted and ignored
  (``chunk_iters < 1`` still raises, as in gpx). ``mesh=`` raises
  ``NotImplementedError``: the distributed likelihood is not ported.
- The ``GPX_UNSAFE_FAST_ADAPT`` environment escape of the fast-warmup
  check is not ported: that configuration always raises.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from gpx_torch import params as gparams
from gpx_torch._device import generators, seeds
from gpx_torch.infer import base, dual_averaging, gibbs, hmc, mh
from gpx_torch.infer import ehmc as ehmc_mod
from gpx_torch.infer import nuts as nuts_mod
from gpx_torch.models import gp
from gpx_torch.ops.distance import check_xy


class PosteriorSamples(NamedTuple):
    """Constrained draws with their names (the reference's CSV chains)."""

    params: Any               # a Parameters tree, leaves (n_chains, n_samples, ...)
    flat: torch.Tensor        # (n_chains, n_samples, dim) constrained values
    names: list
    accept_rate: torch.Tensor  # (n_chains,)
    extras: dict


def _gp_log_density(x, y, log_prior, nugget, safe=False,
                    analytic_gradients=False, mesh=None, fast_gradients=False):
    if mesh is not None:
        if safe or analytic_gradients:
            raise ValueError(
                "mesh= is its own likelihood path (distributed panel "
                "Cholesky) — combine it with neither safe=True nor "
                "analytic_gradients=True")
        raise NotImplementedError("mesh= (the distributed likelihood) is "
                                  "not ported")
    if analytic_gradients:
        if safe:
            raise ValueError("analytic_gradients has no nugget-escalation "
                             "ladder; use safe=False with it")
        # every autograd call of the log-posterior (one per leapfrog step)
        # takes the fused analytic route instead of autograd through the
        # Cholesky
        ll = gp.log_marginal_likelihood_analytic_vjp(
            x, y, nugget=nugget, fast_gradients=fast_gradients)

        def log_density(p):
            return log_prior(p) + ll(p)

        return log_density

    def log_density(p):
        return log_prior(p) + gp.log_marginal_likelihood(p, x, y,
                                                         nugget=nugget,
                                                         safe=safe)

    return log_density


def _package(template, bij_tree, positions, accept_rate, extras):
    """``(n_chains, n_samples, dim)`` unconstrained draws -> a constrained
    ``Parameters`` tree and flat values, leaf by leaf."""
    c, s, _ = positions.shape
    out, i = [], 0
    for b, leaf in zip(gparams.leaves(bij_tree), gparams.leaves(template)):
        k = leaf.numel()
        out.append(b.forward(positions[..., i:i + k].reshape(c, s,
                                                             *leaf.shape)))
        i += k
    return PosteriorSamples(
        params=gparams.unflatten(template, out),
        flat=torch.cat([t.reshape(c, s, -1) for t in out], dim=-1),
        names=gparams.names(template),
        accept_rate=accept_rate,
        extras=extras,
    )


def _disperse(generator, flat0, n_chains, jitter):
    if jitter == 0.0:
        return flat0.expand(n_chains, flat0.numel()).clone()
    return flat0 + jitter * torch.randn((n_chains, flat0.numel()),
                                        generator=generator,
                                        dtype=flat0.dtype, device=flat0.device)


def _run_chains(fn, args):
    """``fn`` on each chain's entry of ``args`` (trees stacked along a
    leading chains axis, or lists), back to back; the results stacked."""
    n = len(args[0])
    return base.stack([fn(*(base.index(a, c) for a in args))
                       for c in range(n)])


def _inits(key, flat0, n_chains, init_jitter):
    """``(inits, run_seed)``: the dispersed starts and the seed of the
    chains' generators, both drawn from ``key``."""
    k_init, k_run = seeds(key, 2)
    flat0 = flat0.detach()
    gen = torch.Generator(device=flat0.device).manual_seed(k_init)
    return _disperse(gen, flat0, n_chains, init_jitter), k_run


def sample_mh(key, x, y, template, log_prior: Callable, n_samples: int, *,
              proposal_scale: float = 0.15, n_chains: int = 4,
              burn_in: int = 0, thin: int = 1,
              nugget: float = gp.LOGML_NUGGET, init_jitter: float = 0.1,
              safe: bool = False, mesh=None, mesh_axis: str = "data",
              panel: int = 128) -> PosteriorSamples:
    """Metropolis-Hastings over every hyperparameter (the reference's
    ``KernelParameters.sample``, KernelParameters.scala:231-246): a
    Gaussian random walk on the unconstrained parameters, the reference's
    log-scale proposal with the Jacobian it omitted. Each proposal is one
    value of :func:`gp.log_marginal_likelihood` (the Gram kernel on the
    card, then the ``torch.linalg`` Cholesky; ``safe=True`` escalates the
    nugget on a failed factor). ``x`` and ``y`` go to the card unless they
    are tensors elsewhere."""
    x, y = check_xy(x, y)
    log_density = _gp_log_density(x, y, log_prior, nugget, safe=safe,
                                  mesh=mesh)
    return sample_mh_log_density(
        key, template, log_density, n_samples,
        proposal_scale=proposal_scale, n_chains=n_chains, burn_in=burn_in,
        thin=thin, init_jitter=init_jitter)


def sample_mh_log_density(key, template, log_density: Callable,
                          n_samples: int, *, proposal_scale: float = 0.15,
                          n_chains: int = 4, burn_in: int = 0, thin: int = 1,
                          init_jitter: float = 0.1,
                          sequential: bool = False) -> PosteriorSamples:
    """Random-walk MH over any model: ``template`` is a parameter tree with
    a ``bijectors()`` method and ``log_density`` maps the constrained tree
    to a scalar (the reference's generic ``Mcmc`` machinery,
    Mcmc.scala:13-33)."""
    logpost, flat0, _ = mh.make_unconstrained_log_posterior(log_density,
                                                            template)
    inits, k_run = _inits(key, flat0, n_chains, init_jitter)
    step = mh.kernel(logpost, mh.gaussian_random_walk(proposal_scale))
    del sequential
    init_states = _run_chains(lambda f: mh.init(f, logpost), (inits,))
    result = base.sample_chains(step, init_states, k_run, n_samples,
                                n_chains, burn_in=burn_in, thin=thin,
                                collect=lambda s: s.position)
    return _package(template, template.bijectors(), result.samples,
                    result.accept_rate, {})


def sample_hmc(key, x, y, template, log_prior: Callable, n_samples: int, *,
               l: int = 10, eps: float | None = None, warmup_iters: int = 500,
               adapt_mass: bool = False, n_chains: int = 4, burn_in: int = 0,
               thin: int = 1, nugget: float = gp.LOGML_NUGGET,
               init_jitter: float = 0.1, analytic_gradients: bool = False,
               fast_warmup: bool = False, gradients: str = "exact",
               probes: int = 64, deflate: int | None = None, mesh=None,
               mesh_axis: str = "data", panel: int = 128,
               chunk_iters: int | None = None,
               program_cache: dict | None = None) -> PosteriorSamples:
    """HMC over every hyperparameter of ``template`` (a ``Parameters``
    tree; its leaves' device and type are the chains'), prior
    ``log_prior``. With ``eps=None`` each chain tunes its step size by dual
    averaging over ``warmup_iters`` transitions (``adapt_mass=True``: a
    Stan-style window with a diagonal mass). ``analytic_gradients=True``
    takes every leapfrog gradient through the fused analytic route
    (:func:`gpx_torch.models.gp.log_marginal_likelihood_analytic_vjp`).

    ``fast_warmup=True`` (needs ``analytic_gradients``) runs the warmup's
    leapfrogs on the 2-pass legs while kept draws stay exact. Combine it
    with a fixed ``eps`` only: adaptive ``eps`` at ``n >= 2048`` raises, as
    gpx does, since the 2-pass value froze dual averaging on the TPU
    (PERF_TPU.md round 4). Below 2048 no route runs the 2-pass legs, so
    there the flag changes nothing.

    ``gradients="hybrid"``: every leapfrog force is the fixed-probe hybrid
    gradient (:func:`gpx_torch.models.gp.log_marginal_likelihood_hybrid_vjp`,
    ``probes``, ``deflate``) while each accept evaluates the exact
    log-density at the trajectory's end, so the chain targets the exact
    posterior; the warmup adapts on the same kernel.

    ``x`` and ``y`` go to the card unless they are tensors elsewhere. See
    the module docstring for ``key``, ``mesh``, ``chunk_iters`` and
    ``program_cache``."""
    if gradients not in ("exact", "hybrid"):
        raise ValueError(f"unknown gradients mode: {gradients!r}")
    x, y = check_xy(x, y)
    force_log_density = None
    if gradients == "hybrid":
        if mesh is not None or fast_warmup:
            raise ValueError(
                "gradients='hybrid' is a single-chip surrogate-force mode "
                "— combine it with neither mesh= nor fast_warmup")
        ll_force = gp.log_marginal_likelihood_hybrid_vjp(
            x, y, nugget=nugget, probes=probes, deflate=deflate)

        def force_log_density(p):
            return log_prior(p) + ll_force(p)

    log_density = _gp_log_density(x, y, log_prior, nugget,
                                  analytic_gradients=analytic_gradients,
                                  mesh=mesh)
    warmup_log_density = _fast_warmup_density(
        fast_warmup, analytic_gradients, mesh, x, y, log_prior, nugget,
        eps=eps)
    return sample_hmc_log_density(
        key, template, log_density, n_samples, l=l, eps=eps,
        warmup_iters=warmup_iters, adapt_mass=adapt_mass, n_chains=n_chains,
        burn_in=burn_in, thin=thin, init_jitter=init_jitter,
        warmup_log_density=warmup_log_density,
        force_log_density=force_log_density, chunk_iters=chunk_iters,
        program_cache=program_cache)


def _fast_warmup_density(fast_warmup, analytic_gradients, mesh, x, y,
                         log_prior, nugget, *, eps):
    # eps is required: eps=None is the adaptive case the check below is for
    if not fast_warmup:
        return None
    if not analytic_gradients or mesh is not None:
        raise ValueError(
            "fast_warmup=True runs the warmup on the 2-pass fused gradient "
            "path — it requires analytic_gradients=True and no mesh")
    if eps is None and x.shape[0] >= 2048:
        raise ValueError(
            "fast_warmup=True with adaptive eps (eps=None) at N >= 2048 is "
            "a measured-broken configuration: the 2-pass program's "
            "warmup-grade logML loosening collapses dual averaging (N=4096 "
            "on the TPU: accept 1.0, step size ~0, chains frozen at their "
            "inits — PERF_TPU.md round 4). Adapt eps on the exact path "
            "(fast_warmup=False) or pass a fixed eps.")
    return _gp_log_density(x, y, log_prior, nugget, analytic_gradients=True,
                           fast_gradients=True)


def sample_hmc_log_density(key, template, log_density: Callable,
                           n_samples: int, *, l: int = 10,
                           eps: float | None = None, warmup_iters: int = 500,
                           adapt_mass: bool = False, n_chains: int = 4,
                           burn_in: int = 0, thin: int = 1,
                           init_jitter: float = 0.1,
                           warmup_log_density: Callable | None = None,
                           force_log_density: Callable | None = None,
                           chunk_iters: int | None = None,
                           program_cache: dict | None = None
                           ) -> PosteriorSamples:
    """HMC over any model: ``template`` is a parameter tree with a
    ``bijectors()`` method and ``log_density`` maps the constrained tree
    to a scalar; gradients by autograd through the bijector lift.
    ``warmup_log_density`` (optional) replaces ``log_density`` in the
    step-size / mass warmup only (e.g. the 2-pass likelihood); kept draws
    target ``log_density``. ``force_log_density`` (optional, exclusive
    with it): surrogate-force mode, its gradient drives every leapfrog
    while accepts evaluate ``log_density`` (:func:`hmc.kernel`)."""
    if force_log_density is not None and warmup_log_density is not None:
        raise ValueError(
            "force_log_density and warmup_log_density are exclusive: the "
            "surrogate-force mode already runs its own (exact-accept) "
            "kernel through warmup")
    logpost, flat0, _ = mh.make_unconstrained_log_posterior(log_density,
                                                            template)
    logpost_wu = logpost if warmup_log_density is None else (
        mh.make_unconstrained_log_posterior(warmup_log_density, template)[0])
    logpost_force = None if force_log_density is None else (
        mh.make_unconstrained_log_posterior(force_log_density, template)[0])
    if adapt_mass and eps is not None:
        raise ValueError(
            "adapt_mass=True estimates the mass matrix during the "
            "dual-averaging warmup, which only runs when eps is None")
    if chunk_iters is not None and chunk_iters < 1:
        raise ValueError("chunk_iters must be >= 1")

    dev = flat0.device
    flat0 = flat0.detach()
    k_init, k_wu, k_run = seeds(key, 3)
    inits = _disperse(torch.Generator(device=dev).manual_seed(k_init), flat0,
                      n_chains, init_jitter)
    wu_gens = generators(k_wu, n_chains, dev)
    run_gens = generators(k_run, n_chains, dev)
    eps_c, mass_c, draws, accept = [], [], [], []
    for c in range(n_chains):
        q0, mass = inits[c], None
        if eps is None:
            if adapt_mass:
                eps_i, mass, q0 = dual_averaging.window_warmup(
                    wu_gens[c], q0, logpost_wu, l0=l,
                    init_window=warmup_iters // 3,
                    mass_window=warmup_iters // 3,
                    final_window=warmup_iters // 3,
                    force_log_posterior=logpost_force)
                mass_c.append(mass)
            else:
                eps_i, q0 = dual_averaging.warmup(
                    wu_gens[c], q0, logpost_wu, warmup_iters, l,
                    force_log_posterior=logpost_force)
        else:
            eps_i = torch.tensor(float(eps), dtype=flat0.dtype, device=dev)
        eps_c.append(eps_i)
        step = hmc.kernel(logpost, eps_i, l, mass=mass,
                          force_log_posterior=logpost_force)
        result = base.sample(step, hmc.init(q0, logpost, logpost_force),
                             run_gens[c], n_samples, burn_in=burn_in,
                             thin=thin, collect=lambda s: s.position)
        draws.append(result.samples)
        accept.append(result.accept_rate)
    extras = {"eps": torch.stack(eps_c)}
    if mass_c:
        extras["mass"] = torch.stack(mass_c)
    return _package(template, template.bijectors(), torch.stack(draws),
                    torch.stack(accept), extras)


def sample_ehmc(key, x, y, template, log_prior: Callable, n_samples: int, *,
                l0: int = 10, warmup_iters: int = 500, k: int = 2000,
                l_max: int = 256, n_chains: int = 4, burn_in: int = 0,
                thin: int = 1, nugget: float = gp.LOGML_NUGGET,
                init_jitter: float = 0.1, analytic_gradients: bool = False,
                mesh=None, mesh_axis: str = "data",
                panel: int = 128) -> PosteriorSamples:
    """Empirical HMC (the reference's ``KernelParameters.sampleEhmc``,
    KernelParameters.scala:169-198). ``k``, the size of the empirical
    U-turn-length distribution, defaults to the reference's 2000
    (Ehmc.scala:95); each length measurement costs a full trajectory of
    logML + gradient evaluations, so lower it for quick runs. Extras: the
    step size and the lengths of each chain."""
    x, y = check_xy(x, y)
    log_density = _gp_log_density(x, y, log_prior, nugget,
                                  analytic_gradients=analytic_gradients,
                                  mesh=mesh)
    return sample_ehmc_log_density(
        key, template, log_density, n_samples, l0=l0,
        warmup_iters=warmup_iters, k=k, l_max=l_max, n_chains=n_chains,
        burn_in=burn_in, thin=thin, init_jitter=init_jitter)


def sample_ehmc_log_density(key, template, log_density: Callable,
                            n_samples: int, *, l0: int = 10,
                            warmup_iters: int = 500, k: int = 2000,
                            l_max: int = 256, n_chains: int = 4,
                            burn_in: int = 0, thin: int = 1,
                            init_jitter: float = 0.1,
                            sequential: bool = False) -> PosteriorSamples:
    """Empirical HMC over any model: the generic core of
    :func:`sample_ehmc` (see :func:`sample_mh_log_density`)."""
    logpost, flat0, _ = mh.make_unconstrained_log_posterior(log_density,
                                                            template)
    inits, k_run = _inits(key, flat0, n_chains, init_jitter)

    def run_one(gen, q0):
        return ehmc_mod.sample(logpost, q0, gen, n_samples, l0=l0,
                               warmup_iters=warmup_iters, k=k, l_max=l_max,
                               burn_in=burn_in, thin=thin)

    del sequential
    result, extras = _run_chains(
        run_one, (generators(k_run, n_chains, inits.device), inits))
    return _package(template, template.bijectors(), result.samples,
                    result.accept_rate, extras)


def sample_nuts(key, x, y, template, log_prior: Callable, n_samples: int, *,
                max_depth: int = 8, eps: float | None = None,
                warmup_iters: int = 500, n_chains: int = 4, burn_in: int = 0,
                thin: int = 1, nugget: float = gp.LOGML_NUGGET,
                init_jitter: float = 0.1, analytic_gradients: bool = False,
                fast_warmup: bool = False, adapt_mass: bool = False,
                mesh=None, mesh_axis: str = "data",
                panel: int = 128) -> PosteriorSamples:
    """No-U-Turn sampling over every hyperparameter. Per chain: a
    dual-averaging warmup when ``eps`` is None (``adapt_mass=True``: the
    windowed warmup with a diagonal mass), then iterative multinomial
    NUTS (:mod:`gpx_torch.infer.nuts`) from over-dispersed starts.
    ``analytic_gradients=True`` takes every leapfrog gradient through the
    fused analytic route, ``fast_warmup`` (with it) runs the warmup on the
    2-pass legs, under :func:`sample_hmc`'s rules. Extras: the step size
    (and the mass) of each chain and the tree ``depth`` of every draw."""
    x, y = check_xy(x, y)
    log_density = _gp_log_density(x, y, log_prior, nugget,
                                  analytic_gradients=analytic_gradients,
                                  mesh=mesh)
    warmup_log_density = _fast_warmup_density(
        fast_warmup, analytic_gradients, mesh, x, y, log_prior, nugget,
        eps=eps)
    return sample_nuts_log_density(
        key, template, log_density, n_samples, max_depth=max_depth, eps=eps,
        warmup_iters=warmup_iters, adapt_mass=adapt_mass, n_chains=n_chains,
        burn_in=burn_in, thin=thin, init_jitter=init_jitter,
        warmup_log_density=warmup_log_density)


def sample_nuts_log_density(key, template, log_density: Callable,
                            n_samples: int, *, max_depth: int = 8,
                            eps: float | None = None, warmup_iters: int = 500,
                            adapt_mass: bool = False, n_chains: int = 4,
                            burn_in: int = 0, thin: int = 1,
                            init_jitter: float = 0.1, sequential: bool = False,
                            warmup_log_density: Callable | None = None
                            ) -> PosteriorSamples:
    """NUTS over any model: the generic core of :func:`sample_nuts` (see
    :func:`sample_mh_log_density`); ``warmup_log_density`` is a cheaper
    surrogate for the warmup only (see :func:`sample_hmc_log_density`)."""
    logpost, flat0, _ = mh.make_unconstrained_log_posterior(log_density,
                                                            template)
    logpost_wu = None if warmup_log_density is None else (
        mh.make_unconstrained_log_posterior(warmup_log_density, template)[0])
    inits, k_run = _inits(key, flat0, n_chains, init_jitter)

    def run_one(gen, q0):
        return nuts_mod.sample(
            logpost, q0, gen, n_samples, max_depth=max_depth, eps=eps,
            warmup_iters=warmup_iters, burn_in=burn_in, thin=thin,
            adapt_mass=adapt_mass, collect=lambda s: (s.position, s.depth),
            warmup_log_posterior=logpost_wu)

    del sequential
    result, extras = _run_chains(
        run_one, (generators(k_run, n_chains, inits.device), inits))
    positions, depths = result.samples
    return _package(template, template.bijectors(), positions,
                    result.accept_rate, dict(extras, depth=depths))


class _GibbsState(NamedTuple):
    params: Any
    accepted: torch.Tensor


def sample_mh_within_gibbs(key, x, y, template, log_prior_kernel: Callable,
                           prior_mean, n_samples: int, *,
                           proposal_scale: float = 0.15, n_chains: int = 4,
                           burn_in: int = 0, thin: int = 1,
                           nugget: float = gp.LOGML_NUGGET,
                           mean_nugget: float = 1e-6) -> PosteriorSamples:
    """Metropolis-within-Gibbs (the reference's ``Mcmc.sample``,
    Mcmc.scala:63-76): each iteration a conjugate Gibbs draw of the plane
    mean (:func:`gibbs.sample_mean`, prior ``prior_mean``) and one MH move
    on the kernel's unconstrained hyperparameters (prior
    ``log_prior_kernel`` of the kernel). Every chain starts at
    ``template``."""
    x, y = check_xy(x, y)
    bij_k = template.kernel.bijectors()
    _, unravel_k = gparams.unraveler(gparams.unconstrain(bij_k,
                                                         template.kernel))

    def step(gen, state: _GibbsState) -> _GibbsState:
        params = gibbs.sample_mean(gen, prior_mean, x, y, state.params,
                                   nugget=mean_nugget)

        def logpost(uf):
            kern = gparams.constrain(bij_k, unravel_k(uf))
            p = gparams.Parameters(mean=params.mean, kernel=kern)
            return (log_prior_kernel(kern)
                    + gp.log_marginal_likelihood(p, x, y, nugget=nugget)
                    + gparams.log_det_jacobian(bij_k, unravel_k(uf)))

        with torch.no_grad():
            u = gparams.to_array(gparams.unconstrain(bij_k, params.kernel))
            prop = u + proposal_scale * torch.randn(
                u.shape, generator=gen, dtype=u.dtype, device=u.device)
            lp_cur = logpost(u)
            lp_prop = logpost(prop)
        lp_prop = torch.where(torch.isnan(lp_prop), float("-inf"), lp_prop)
        uni = torch.rand((), generator=gen, dtype=u.dtype, device=u.device)
        accept = torch.log(uni) < (lp_prop - lp_cur)
        kern = gparams.constrain(bij_k, unravel_k(torch.where(accept, prop,
                                                              u)))
        return _GibbsState(gparams.Parameters(mean=params.mean, kernel=kern),
                           state.accepted + accept.to(torch.int32))

    dev = gparams.leaves(template)[0].device
    init = _GibbsState(template, torch.zeros((), dtype=torch.int32,
                                             device=dev))
    result = base.sample_chains(step, init, key, n_samples, n_chains,
                                burn_in=burn_in, thin=thin,
                                collect=lambda s: s.params)
    draws = gparams.leaves(result.samples)
    c, s = draws[0].shape[:2]
    return PosteriorSamples(
        params=result.samples,
        flat=torch.cat([t.reshape(c, s, -1) for t in draws], dim=-1),
        names=gparams.names(template),
        accept_rate=result.accept_rate,
        extras={},
    )
