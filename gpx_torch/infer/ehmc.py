"""Empirical HMC (Wu et al.) — the port of ``gpx/infer/ehmc.py`` (the
reference's ``Ehmc``, Ehmc.scala).

A dual-averaging warmup picks the step size, a second phase measures the
distribution of U-turn-free trajectory lengths over ``k`` transitions, and
the main chain draws its leapfrog count from that distribution each
iteration. The JAX package's fixes of the reference stay: the mass matrix
is honoured, the warmup's step size is linear, and the MH-corrected
proposal always integrates exactly ``l0`` steps.

The U-turn search is a Python loop that reads one flag to the host per
leapfrog; the lengths are a ``(k,)`` integer tensor on the device.
"""

from __future__ import annotations

from typing import Callable

import torch

from gpx_torch.infer import base, dual_averaging, hmc


def is_u_turn(q0, q, p):
    """``(q - q0) . p < 0``, a NaN counting as a U-turn (Ehmc.isUTurn,
    Ehmc.scala:9-26)."""
    out = torch.sum((q - q0) * p)
    return torch.where(torch.isnan(out), True, out < 0.0)


def longest_batch_step(generator, state: hmc.HMCState, vag, eps, l0: int,
                       l_max: int, mass):
    """One fixed-``l0`` HMC transition that also measures the U-turn-free
    trajectory length (Ehmc.longestBatch + longestBatchStep,
    Ehmc.scala:28-78): the trajectory runs on past ``l0`` until it turns
    or reaches ``l_max``. Returns ``(new_state, length)``; the momenta
    and the accept's uniform come from ``generator``, in that order."""
    inv_mass = 1.0 if mass is None else 1.0 / mass
    std = 1.0 if mass is None else torch.sqrt(mass)
    q0 = state.position
    p0 = std * torch.randn(q0.shape, generator=generator, dtype=q0.dtype,
                           device=q0.device)
    q, p, g, lp = q0, p0, state.grad, state.log_prob
    prop = (q0, p0, state.grad, state.log_prob)
    length, turned, step = l_max, False, 0
    while step < l0 or (not turned and step < l_max):
        p_half = p + 0.5 * eps * g
        q = q + eps * (inv_mass * p_half)
        lp, g = vag(q)
        p = p_half + 0.5 * eps * g
        step += 1
        if step == l0:
            prop = (q, p, g, lp)
        if not turned and bool(is_u_turn(q0, q, p)):
            turned, length = True, step
    prop_q, prop_p, prop_g, prop_lp = prop
    log_a = hmc.log_acceptance(prop_lp, prop_p, state.log_prob, p0, inv_mass)
    u = torch.rand((), generator=generator, dtype=q0.dtype, device=q0.device)
    accept = torch.log(u) < log_a
    new_state = hmc.HMCState(
        position=torch.where(accept, prop_q, q0),
        log_prob=torch.where(accept, prop_lp, state.log_prob),
        grad=torch.where(accept, prop_g, state.grad),
        accepted=state.accepted + accept.to(torch.int32),
    )
    return new_state, length


def empirical_lengths(generator, state, vag, eps, l0: int, k: int,
                      l_max: int, mass):
    """The U-turn-free lengths of ``k`` warmup transitions
    (Ehmc.empiricalLongestStep, Ehmc.scala:85-99): ``(state, lengths)``."""
    lengths = []
    for _ in range(k):
        state, length = longest_batch_step(generator, state, vag, eps, l0,
                                           l_max, mass)
        lengths.append(length)
    return state, torch.tensor(lengths, dtype=torch.int32,
                               device=state.position.device)


def sample(log_posterior: Callable, init_position, key, n_samples: int, *,
           l0: int = 10, warmup_iters: int = 1000, k: int = 2000,
           l_max: int = 1024, burn_in: int = 0, thin: int = 1, mass=None,
           collect=lambda s: s.position):
    """The eHMC pipeline (Ehmc.sample, Ehmc.scala:101-123): the step-size
    warmup, the length measurement, then the main chain drawing its
    leapfrog count from the measured lengths. ``key`` is a
    ``torch.Generator`` used in that order. Returns ``(ChainResult,
    {"eps", "lengths"})``."""
    vag = hmc.value_and_grad(log_posterior)
    eps, position = dual_averaging.warmup(key, init_position, log_posterior,
                                          warmup_iters, l0, mass=mass)
    state = hmc.init(position, log_posterior)
    state, lengths = empirical_lengths(key, state, vag, eps, l0, k, l_max,
                                       mass)
    counts = lengths.tolist()

    def step(gen, s):
        idx = int(torch.randint(0, k, (), generator=gen,
                                device=gen.device))
        return hmc._step(gen, s, vag, eps, counts[idx], mass)[0]

    result = base.sample(
        step, state._replace(accepted=torch.zeros_like(state.accepted)),
        key, n_samples, burn_in=burn_in, thin=thin, collect=collect)
    return result, {"eps": eps, "lengths": lengths}
