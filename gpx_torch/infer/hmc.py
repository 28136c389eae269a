"""Hamiltonian Monte Carlo — the port of ``gpx/infer/hmc.py`` (the
reference's ``Hmc``, Hmc.scala).

As in the JAX package, on purpose unlike the reference: the gradient
comes from autograd of the log-posterior (one call per leapfrog step; the
reference's hand-derived ``mllGradient`` has sign errors), the leapfrog
carries the gradient from one step to the next, and the kinetic energy
honours the diagonal mass ``M`` (momenta ``N(0, M)``, kinetic ``0.5 p^T
M^-1 p``; the reference ignores ``M`` there, Hmc.scala:59-68).

A log-posterior built on :func:`gpx_torch.models.gp.
log_marginal_likelihood_analytic_vjp` makes each autograd call one fused
logML + gradient evaluation on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class HMCState(NamedTuple):
    position: torch.Tensor   # flat unconstrained vector
    log_prob: torch.Tensor
    grad: torch.Tensor
    accepted: torch.Tensor


def value_and_grad(fn: Callable):
    """``q -> (fn(q), d fn / dq)``, both detached."""

    def vag(q):
        q = q.detach().requires_grad_()
        with torch.enable_grad():
            lp = fn(q)
            (g,) = torch.autograd.grad(lp, q)
        return lp.detach(), g

    return vag


def _value(fn: Callable, q):
    with torch.no_grad():
        return fn(q)


def init(position, log_posterior, force_log_posterior=None) -> HMCState:
    """``force_log_posterior`` (optional): a surrogate whose gradient drives
    the leapfrog while ``log_posterior`` gives the accept's exact values
    (see :func:`kernel`)."""
    if force_log_posterior is None:
        lp, g = value_and_grad(log_posterior)(position)
    else:
        lp = _value(log_posterior, position)
        g = value_and_grad(force_log_posterior)(position)[1]
    return HMCState(position, lp, g,
                    torch.zeros((), dtype=torch.int32, device=lp.device))


def leapfrog(value_and_grad_fn, q, p, grad, eps, l, inv_mass):
    """``l`` leapfrog steps (Hmc.leapfrogs, Hmc.scala:44-56), one gradient
    evaluation a step. Returns ``(q, p, grad, log_prob)`` at the end."""
    lp = torch.full((), float("-inf"), dtype=q.dtype, device=q.device)
    for _ in range(int(l)):
        p_half = p + 0.5 * eps * grad
        q = q + eps * (inv_mass * p_half)
        lp, grad = value_and_grad_fn(q)
        p = p_half + 0.5 * eps * grad
    return q, p, grad, lp


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(p * p * inv_mass)


def log_acceptance(lp_prop, p_prop, lp0, p0, inv_mass):
    """Hmc.logAcceptance with its NaN guard (Hmc.scala:78-85)."""
    a = (lp_prop - _kinetic(p_prop, inv_mass)) - (lp0 - _kinetic(p0, inv_mass))
    a = torch.where(torch.isnan(a), float("-inf"), a)
    return torch.clamp_max(a, 0.0)


def kernel(log_posterior: Callable, eps, l, mass=None,
           force_log_posterior: Callable | None = None):
    """One HMC transition ``(generator, HMCState) -> HMCState`` (Hmc.step,
    Hmc.scala:87-105).

    ``force_log_posterior`` (optional): a surrogate whose gradient drives
    the leapfrog while the Metropolis accept evaluates the exact
    ``log_posterior`` at the trajectory's end. Any deterministic force
    field keeps the leapfrog reversible and volume-preserving, so the
    exact accept keeps the posterior invariant; only the accept rate pays
    for the mismatch. The intended surrogate is the fixed-probe hybrid
    gradient (:func:`gpx_torch.models.gp.log_marginal_likelihood_hybrid_vjp`)."""
    vag = value_and_grad(log_posterior)
    value_fn = None
    if force_log_posterior is not None:
        vag = value_and_grad(force_log_posterior)
        value_fn = log_posterior

    def step(generator, state: HMCState) -> HMCState:
        return _step(generator, state, vag, eps, l, mass,
                     value_fn=value_fn)[0]

    return step


def _step(generator, state: HMCState, vag, eps, l, mass, value_fn=None):
    """One transition; returns ``(new_state, log_acceptance)`` (the second
    feeds dual averaging). ``value_fn`` (surrogate-force mode) evaluates
    the accept's log-density at the trajectory's end: one exact value per
    trajectory. The momenta and the accept's uniform come from
    ``generator``, in that order."""
    q0 = state.position
    inv_mass = 1.0 if mass is None else 1.0 / mass
    std = 1.0 if mass is None else torch.sqrt(mass)
    p0 = std * torch.randn(q0.shape, generator=generator, dtype=q0.dtype,
                           device=q0.device)
    q_new, p_new, grad_new, lp_new = leapfrog(vag, q0, p0, state.grad, eps,
                                              l, inv_mass)
    if value_fn is not None:
        lp_new = _value(value_fn, q_new)
    log_a = log_acceptance(lp_new, p_new, state.log_prob, p0, inv_mass)
    u = torch.rand((), generator=generator, dtype=q0.dtype, device=q0.device)
    accept = torch.log(u) < log_a
    new_state = HMCState(
        position=torch.where(accept, q_new, q0),
        log_prob=torch.where(accept, lp_new, state.log_prob),
        grad=torch.where(accept, grad_new, state.grad),
        accepted=state.accepted + accept.to(torch.int32),
    )
    return new_state, log_a
