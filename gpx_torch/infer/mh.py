"""Metropolis-Hastings on the unconstrained space, and the bijector lift
every sampler here runs in — the port of ``gpx/infer/mh.py``.

The reference proposes a log-scale random walk on the constrained
parameters with a symmetric-proposal accept (KernelParameters.scala:
231-246, SimulatedGp.scala:115-130), which biases its chain; a symmetric
walk on the unconstrained parameters plus the bijectors' log-Jacobian is
the same move with the right stationary distribution.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from gpx_torch import params as gparams


class MHState(NamedTuple):
    position: Any            # a flat unconstrained tensor (or a list)
    log_prob: torch.Tensor
    accepted: torch.Tensor   # running acceptance count


def init(position, log_posterior) -> MHState:
    with torch.no_grad():
        lp = log_posterior(position)
    return MHState(position=position, log_prob=lp,
                   accepted=torch.zeros((), dtype=torch.int32,
                                        device=lp.device))


def gaussian_random_walk(scale):
    """Symmetric proposal ``q' = q + scale * z`` over a tensor or a list
    of tensors."""

    def propose(generator, position):
        def one(t):
            return t + scale * torch.randn(t.shape, generator=generator,
                                           dtype=t.dtype, device=t.device)

        if isinstance(position, torch.Tensor):
            return one(position)
        return type(position)(one(t) for t in position)

    return propose


def kernel(log_posterior: Callable, proposal: Callable):
    """One MH transition ``(generator, MHState) -> MHState``; a NaN
    log-density rejects (the reference guards HMC so, Hmc.scala:84)."""

    def step(generator, state: MHState) -> MHState:
        prop = proposal(generator, state.position)
        with torch.no_grad():
            lp = log_posterior(prop)
        lp = torch.where(torch.isnan(lp), float("-inf"), lp)
        u = torch.rand((), generator=generator, dtype=lp.dtype,
                       device=lp.device)
        accept = torch.log(u) < lp - state.log_prob
        if isinstance(prop, torch.Tensor):
            position = torch.where(accept, prop, state.position)
        else:
            position = type(prop)(torch.where(accept, p, q)
                                  for p, q in zip(prop, state.position))
        return MHState(position=position,
                       log_prob=torch.where(accept, lp, state.log_prob),
                       accepted=state.accepted + accept.to(torch.int32))

    return step


def make_unconstrained_log_posterior(log_density: Callable, template,
                                     bij_tree=None):
    """Lift a log-density over constrained parameter trees to one over flat
    unconstrained tensors, plus the bijectors' log-Jacobian
    (KernelParameters.scala:146-148's unconstrain-then-sample, with the
    Jacobian the reference's MH omits).

    Returns ``(log_posterior(flat) -> scalar, flat0, unravel)``."""
    if bij_tree is None:
        bij_tree = template.bijectors()
    u0 = gparams.unconstrain(bij_tree, template)
    flat0, unravel = gparams.unraveler(u0)

    def log_posterior(flat):
        u = unravel(flat)
        c = gparams.constrain(bij_tree, u)
        return log_density(c) + gparams.log_det_jacobian(bij_tree, u)

    return log_posterior, flat0, unravel
