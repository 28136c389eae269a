"""The chain runner — the port of ``gpx/infer/base.py``'s ``sample``.

A transition kernel is ``step(generator, state) -> state``: it draws its
randomness from the ``torch.Generator`` it is given, in order, where the
JAX package splits a key. ``sample`` runs one chain as a Python loop and
keeps every ``thin``-th state after ``burn_in``; the kept states stay on
the device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class ChainResult(NamedTuple):
    samples: Any          # stacked along a leading draws axis
    final_state: Any
    accept_rate: torch.Tensor


def _stack(items):
    """Stack tensors, or the fields of tuples of tensors, along a new
    leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return type(first)(*(_stack(list(f)) for f in zip(*items)))


def sample(step: Callable, init_state, generator, n_samples: int, *,
           burn_in: int = 0, thin: int = 1,
           collect: Callable[[Any], Any] = lambda s: s) -> ChainResult:
    """Run one chain: ``burn_in + n_samples * thin`` transitions, keeping
    ``collect(state)`` of every ``thin``-th state after the burn-in (the
    reference drops burn-in and thins when it reads its CSV,
    Temperature.scala:137-141)."""
    state = init_state
    for _ in range(burn_in):
        state = step(generator, state)
    draws = []
    for _ in range(n_samples):
        for _ in range(thin):
            state = step(generator, state)
        draws.append(collect(state))
    return ChainResult(samples=_stack(draws), final_state=state,
                       accept_rate=_accept_rate(state,
                                                burn_in + n_samples * thin))


def _accept_rate(state, n_steps: int):
    accepted = getattr(state, "accepted", None)
    if accepted is None:
        return torch.tensor(float("nan"))
    return accepted / n_steps
