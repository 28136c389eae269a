"""Nesterov dual-averaging step sizes (the NUTS paper's scheme, delta =
0.65) — the port of ``gpx/infer/dual_averaging.py`` (the reference's
``DualAverage``, DualAveraging.scala). The two reference faults the JAX
package fixes stay fixed: the state's fields are in order
(DualAveraging.scala:64), and the warmup returns ``exp(logepsbar)``, not
the log step size (DualAveraging.scala:121-125).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gpx_torch.infer import hmc


class DAState(NamedTuple):
    """DualAverageState (DualAveraging.scala:7-11), without the position."""

    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor


def update_eps(m, mu, delta, accept_prob, s: DAState, k=0.75, gamma=0.05,
               t0=10.0):
    """DualAverage.updateEps (DualAveraging.scala:26-46) at iteration
    ``m >= 1``."""
    md = float(m)
    ra = 1.0 / (md + t0)
    h_bar = (1.0 - ra) * s.h_bar + ra * (delta - accept_prob)
    log_eps = mu - (math.sqrt(md) * h_bar) / gamma
    power = md ** (-k)
    log_eps_bar = power * log_eps + (1.0 - power) * s.log_eps_bar
    return DAState(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar)


def _pieces(log_posterior, force_log_posterior):
    """``(value_and_grad of the force, exact value function or None)``."""
    if force_log_posterior is None:
        return hmc.value_and_grad(log_posterior), None
    return hmc.value_and_grad(force_log_posterior), log_posterior


def find_reasonable_epsilon(generator, position, log_posterior, mass=None,
                            force_log_posterior=None):
    """DualAverage.findReasonableEpsilon (DualAveraging.scala:70-100):
    double or halve ``eps`` until the one-step acceptance crosses 1/2, at
    most 100 times. ``force_log_posterior``: surrogate-force mode (see
    :func:`hmc.kernel`)."""
    vag, value_fn = _pieces(log_posterior, force_log_posterior)
    if value_fn is None:
        lp0, grad0 = vag(position)
    else:
        lp0 = hmc._value(value_fn, position)
        grad0 = vag(position)[1]
    inv_mass = 1.0 if mass is None else 1.0 / mass
    std = 1.0 if mass is None else torch.sqrt(mass)
    p0 = std * torch.randn(position.shape, generator=generator,
                           dtype=position.dtype, device=position.device)

    def log_accept(eps):
        q1, p1, _, lp1 = hmc.leapfrog(vag, position, p0, grad0, eps, 1,
                                      inv_mass)
        if value_fn is not None:
            lp1 = hmc._value(value_fn, q1)
        return float(hmc.log_acceptance(lp1, p1, lp0, p0, inv_mass))

    eps = torch.ones((), dtype=position.dtype, device=position.device)
    la = log_accept(eps)
    a = 1.0 if la > math.log(0.5) else -1.0
    count = 0
    while a * la > -a * math.log(2.0) and count < 100:
        eps = eps * 2.0 ** a
        count += 1
        la = log_accept(eps)
    return eps


def warmup(generator, position, log_posterior: Callable, n_warmup: int,
           l0: int, *, delta: float = 0.65, mass=None,
           force_log_posterior: Callable | None = None):
    """DualAverage.tuneStepsize (DualAveraging.scala:108-126).

    Returns ``(eps, warmed_position)``: ``exp(logepsbar)`` and the chain's
    position after the warmup, where sampling resumes.
    ``force_log_posterior``: the warmup adapts on the surrogate-force
    kernel that sampling will use."""
    eps0 = find_reasonable_epsilon(generator, position, log_posterior, mass,
                                   force_log_posterior)
    mu = torch.log(10.0 * eps0)
    state = hmc.init(position, log_posterior, force_log_posterior)
    da = DAState(log_eps=torch.log(eps0), log_eps_bar=torch.zeros_like(eps0),
                 h_bar=torch.zeros_like(eps0))
    vag, value_fn = _pieces(log_posterior, force_log_posterior)
    for m in range(1, n_warmup + 1):
        state, log_a = hmc._step(generator, state, vag, torch.exp(da.log_eps),
                                 l0, mass, value_fn=value_fn)
        accept_prob = torch.clamp_max(torch.exp(log_a), 1.0)
        da = update_eps(m, mu, delta, accept_prob, da)
    return torch.exp(da.log_eps_bar), state.position


def mass_from_draws(draws):
    """The diagonal mass of the window warmup from ``(iters, dim)`` draws:
    ``1 / (var + 1e-6)``, the momenta's precision the posterior variance."""
    return 1.0 / (torch.var(draws, dim=0, correction=0) + 1e-6)


def window_warmup(generator, position, log_posterior: Callable, *,
                  l0: int = 10, init_window: int = 150,
                  mass_window: int = 300, final_window: int = 150,
                  delta: float = 0.65,
                  force_log_posterior: Callable | None = None):
    """Stan-style windowed warmup: dual-average the step size with unit
    mass, estimate a diagonal mass from a window of draws
    (:func:`mass_from_draws`), then tune the step size again under that
    mass. Returns ``(eps, mass, position)``."""
    eps0, position = warmup(generator, position, log_posterior, init_window,
                            l0, delta=delta,
                            force_log_posterior=force_log_posterior)
    vag, value_fn = _pieces(log_posterior, force_log_posterior)
    state = hmc.init(position, log_posterior, force_log_posterior)
    draws = []
    for _ in range(mass_window):
        state, _ = hmc._step(generator, state, vag, eps0, l0, None,
                             value_fn=value_fn)
        draws.append(state.position)
    mass = mass_from_draws(torch.stack(draws))
    eps, position = warmup(generator, state.position, log_posterior,
                           final_window, l0, delta=delta, mass=mass,
                           force_log_posterior=force_log_posterior)
    return eps, mass, position
