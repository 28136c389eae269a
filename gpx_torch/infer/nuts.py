"""No-U-Turn Sampler (iterative, multinomial) — the port of
``gpx/infer/nuts.py``.

The same algorithm: no recursion and a fixed ``max_depth``. Subtree U-turn
checks use the checkpoint stack of iterative NUTS (Phan & Pradhan): leaf
``n`` of a subtree stores its state in slot ``popcount(n)`` when ``n`` is
even, and when leaf ``n`` completes, every power-of-two-aligned interval
ending at ``n`` is checked against the slot of its left endpoint. Sampling
is progressive multinomial within a subtree and biased across subtrees
(Stan's): a new subtree's proposal replaces the running one with
probability ``exp(logw_subtree - logw_tree)``. A leaf whose energy error
passes ``max_delta = 1000`` diverges.

Python loops replace ``lax.while_loop``: after each leaf one flag (turned
or diverged) is read to the host to decide whether the subtree goes on,
and after each doubling one more, so each leapfrog gradient pays one
small device-to-host read. Randomness comes from one ``torch.Generator``
in a fixed order: the momenta, then per doubling the direction, each
leaf's multinomial uniform and the subtree's acceptance uniform.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gpx_torch.infer import base, dual_averaging, hmc


class NUTSState(NamedTuple):
    position: torch.Tensor
    log_prob: torch.Tensor
    grad: torch.Tensor
    accepted: torch.Tensor   # transitions that moved (diagnostics)
    depth: torch.Tensor      # the last transition's tree depth (treedepth)


def init(position, log_posterior) -> NUTSState:
    lp, g = hmc.value_and_grad(log_posterior)(position)
    z = torch.zeros((), dtype=torch.int32, device=lp.device)
    return NUTSState(position, lp, g, z, z)


def _popcount(n: int) -> int:
    return bin(n).count("1")


class _Subtree(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    g: torch.Tensor
    prop_q: torch.Tensor
    prop_lp: torch.Tensor
    prop_g: torch.Tensor
    log_w: torch.Tensor
    stopped: bool            # turned or diverged


def kernel(log_posterior: Callable, eps, max_depth: int = 10, mass=None):
    """One NUTS transition ``(generator, NUTSState) -> NUTSState``."""
    vag = hmc.value_and_grad(log_posterior)
    inv_mass = 1.0 if mass is None else 1.0 / mass
    std = 1.0 if mass is None else torch.sqrt(mass)
    max_delta = 1000.0  # divergence threshold (Stan's default)

    def kinetic(p):
        return 0.5 * torch.sum(p * p * inv_mass)

    def leapfrog(q, p, g, direction):
        e = eps * direction
        p_half = p + 0.5 * e * g
        q_new = q + e * (inv_mass * p_half)
        lp_new, g_new = vag(q_new)
        return q_new, p_half + 0.5 * e * g_new, g_new, lp_new

    def is_turn_dq(dq, p_a, p_b):
        """Generalized U-turn criterion, ``dq`` oriented in trajectory-time
        order (time-later minus time-earlier position); NaN turns."""
        turn = (torch.dot(dq, inv_mass * p_a) < 0) | (
            torch.dot(dq, inv_mass * p_b) < 0)
        return turn | torch.isnan(torch.dot(dq, p_a))

    def uniform(gen, like):
        return torch.rand((), generator=gen, dtype=like.dtype,
                          device=like.device)

    def build_subtree(gen, q, p, g, direction: float, depth: int, h0):
        """``2^depth`` leapfrogs from ``(q, p, g)``, stopping after the leaf
        that turns or diverges."""
        ck_q = [None] * (max_depth + 1)
        ck_p = [None] * (max_depth + 1)
        neg_inf = torch.full((), -math.inf, dtype=q.dtype, device=q.device)
        prop_q, prop_lp, prop_g, log_w = q, neg_inf, g, neg_inf
        for n in range(1 << depth):
            q, p, g, lp = leapfrog(q, p, g, direction)
            w1 = lp - kinetic(p) - h0
            w1 = torch.where(torch.isnan(w1), -math.inf, w1)
            stop = w1 < -max_delta

            # progressive multinomial within the subtree
            log_w_new = torch.logaddexp(log_w, w1)
            take = torch.log(uniform(gen, q)) < (w1 - log_w_new)
            prop_q = torch.where(take, q, prop_q)
            prop_lp = torch.where(take, lp, prop_lp)
            prop_g = torch.where(take, g, prop_g)
            log_w = log_w_new

            # checkpoint-stack U-turn checks
            if n % 2 == 0:
                ck_q[_popcount(n)], ck_p[_popcount(n)] = q, p
            j = 1
            while (n + 1) % (1 << j) == 0:
                a_slot = _popcount(n + 1 - (1 << j))
                # checkpoint a precedes leaf n in generation order, which a
                # backward subtree (direction -1) runs against time: orient
                # dq into trajectory-time order (momenta are unsigned)
                dq = direction * (q - ck_q[a_slot])
                stop = stop | is_turn_dq(dq, ck_p[a_slot], p)
                j += 1
            if bool(stop):
                return _Subtree(q, p, g, prop_q, prop_lp, prop_g, log_w,
                                True)
        return _Subtree(q, p, g, prop_q, prop_lp, prop_g, log_w, False)

    def step(gen, state: NUTSState) -> NUTSState:
        q0 = state.position
        p0 = std * torch.randn(q0.shape, generator=gen, dtype=q0.dtype,
                               device=q0.device)
        h0 = state.log_prob - kinetic(p0)
        # tree ends: (q, p, grad), left (0) and right (1)
        ends = [(q0, p0, state.grad), (q0, p0, state.grad)]
        prop_q, prop_lp, prop_g = q0, state.log_prob, state.grad
        log_w = torch.zeros((), dtype=q0.dtype, device=q0.device)  # w(z0) = 1
        depth = 0
        while depth < max_depth:
            end = 1 if bool(uniform(gen, q0) < 0.5) else 0
            sub = build_subtree(gen, *ends[end], 1.0 if end else -1.0,
                                depth, h0)
            depth += 1
            u = uniform(gen, q0)
            if sub.stopped:
                break
            # biased progressive acceptance of the new subtree's proposal
            take = torch.log(u) < (sub.log_w - log_w)
            prop_q = torch.where(take, sub.prop_q, prop_q)
            prop_lp = torch.where(take, sub.prop_lp, prop_lp)
            prop_g = torch.where(take, sub.prop_g, prop_g)
            log_w = torch.logaddexp(log_w, sub.log_w)
            ends[end] = (sub.q, sub.p, sub.g)
            (q_l, p_l, _), (q_r, p_r, _) = ends
            if bool(is_turn_dq(q_r - q_l, p_l, p_r)):
                break
        moved = torch.any(prop_q != q0)
        return NUTSState(
            position=prop_q, log_prob=prop_lp, grad=prop_g,
            accepted=state.accepted + moved.to(torch.int32),
            depth=torch.tensor(depth, dtype=torch.int32, device=q0.device))

    return step


def sample(log_posterior: Callable, init_position, key, n_samples: int, *,
           max_depth: int = 10, eps: float | None = None,
           warmup_iters: int = 500, burn_in: int = 0, thin: int = 1,
           mass=None, adapt_mass: bool = False,
           collect=lambda s: s.position,
           warmup_log_posterior: Callable | None = None):
    """NUTS with an optional dual-averaging step-size warmup (HMC with 10
    leapfrogs a transition, as in the JAX package). ``key`` is a
    ``torch.Generator`` on the position's device; the warmup draws from it
    first, then the chain.

    ``warmup_log_posterior``: a cheaper surrogate driven only during the
    warmup (e.g. the 2-pass likelihood); the kept draws target
    ``log_posterior``. ``adapt_mass=True`` runs the windowed warmup
    (:func:`dual_averaging.window_warmup`: eps under unit mass, a window
    estimating a diagonal mass, eps again under it). Returns
    ``(ChainResult, extras)`` with the step size (and the mass)."""
    if adapt_mass and eps is not None:
        raise ValueError(
            "adapt_mass=True estimates the mass matrix during the "
            "dual-averaging warmup, which only runs when eps is None — "
            "pass eps=None (or drop adapt_mass and supply mass= directly)")
    position = init_position
    lp_wu = (log_posterior if warmup_log_posterior is None
             else warmup_log_posterior)
    if eps is None and adapt_mass:
        third = max(warmup_iters // 3, 10)
        eps, mass, position = dual_averaging.window_warmup(
            key, position, lp_wu, init_window=third, mass_window=third,
            final_window=third)
    elif eps is None:
        eps, position = dual_averaging.warmup(key, position, lp_wu,
                                              warmup_iters, 10, mass=mass)
    else:
        eps = torch.tensor(float(eps), dtype=position.dtype,
                           device=position.device)
    step = kernel(log_posterior, eps, max_depth=max_depth, mass=mass)
    result = base.sample(step, init(position, log_posterior), key, n_samples,
                         burn_in=burn_in, thin=thin, collect=collect)
    extras = {"eps": eps}
    if adapt_mass:
        extras["mass"] = mass
    return result, extras
