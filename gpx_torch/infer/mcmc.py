"""GP hyperparameter inference by HMC — the port of ``sample_hmc`` and
``sample_hmc_log_density`` of ``gpx/infer/mcmc.py`` (the reference's
``KernelParameters.sampleHmc``, KernelParameters.scala:121-154).

Differences from the JAX package, by design of the port:
- ``key`` is a ``torch.Generator`` or an int seed. Three seeds drawn from
  it start the inits, the warmups and the sampling; each chain gets its
  own generators, seeded from those, on the parameters' device.
- Chains run back to back (gpx's ``sequential=True``): one fused
  evaluation already fills the card.
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
from gpx_torch.infer import base, dual_averaging, hmc, mh
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


def _seeds(key, n: int) -> list[int]:
    """``n`` seeds drawn from ``key``: an int seed or a ``torch.Generator``
    (which advances)."""
    gen = key
    if not isinstance(key, torch.Generator):
        gen = torch.Generator().manual_seed(int(key))
    return torch.randint(0, 2 ** 62, (n,), generator=gen,
                         device=gen.device).tolist()


def _generators(seed: int, n: int, device) -> list[torch.Generator]:
    """``n`` generators on ``device``, seeded from ``seed``."""
    return [torch.Generator(device=device).manual_seed(s)
            for s in _seeds(seed, n)]


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
    k_init, k_wu, k_run = _seeds(key, 3)
    inits = _disperse(torch.Generator(device=dev).manual_seed(k_init), flat0,
                      n_chains, init_jitter)
    wu_gens = _generators(k_wu, n_chains, dev)
    run_gens = _generators(k_run, n_chains, dev)
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
