"""The chain runner — the port of ``gpx/infer/base.py``.

A transition kernel is ``step(generator, state) -> state``: it draws its
randomness from the ``torch.Generator`` it is given, in order, where the
JAX package splits a key. ``sample`` runs one chain as a Python loop and
keeps every ``thin``-th state after ``burn_in``; the kept states stay on
the device. ``sample_chains`` runs chains back to back, one generator
each, where the JAX package vmaps them: every kernel of the port works on
one problem at a time.

A state is a tensor, a (named) tuple, a dict or a parameter tree of
tensors; :func:`stack` stacks such trees along a new leading axis and
:func:`index` takes one entry of that axis back out.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from gpx_torch._device import generators
from gpx_torch._module import FieldModule
from gpx_torch.params import leaves, unflatten


# A transition kernel: (generator, state) -> state, where state is any tree
# of tensors that stack() can stack.
TransitionKernel = Callable[[torch.Generator, Any], Any]


class ChainResult(NamedTuple):
    samples: Any          # stacked along a leading draws axis
    final_state: Any
    accept_rate: torch.Tensor


def stack(items):
    """Stack same-shaped trees along a new leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, FieldModule):
        return unflatten(first, [torch.stack(ls) for ls in
                                 zip(*(leaves(t) for t in items))])
    if isinstance(first, dict):
        return {k: stack([t[k] for t in items]) for k in first}
    fields = [stack(list(f)) for f in zip(*items)]
    return type(first)(*fields) if hasattr(first, "_fields") else type(
        first)(fields)


def index(tree, i: int):
    """Entry ``i`` of a stacked tree's leading axis (an item of a list)."""
    if isinstance(tree, (torch.Tensor, list)):
        return tree[i]
    if isinstance(tree, FieldModule):
        return unflatten(tree, [t[i] for t in leaves(tree)])
    if isinstance(tree, dict):
        return {k: index(v, i) for k, v in tree.items()}
    fields = [index(f, i) for f in tree]
    return type(tree)(*fields) if hasattr(tree, "_fields") else type(
        tree)(fields)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, FieldModule):
        return leaves(tree)
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for f in tree for t in _tensors(f)]


def sample(step: TransitionKernel, init_state, generator, n_samples: int, *,
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
    return ChainResult(samples=stack(draws), final_state=state,
                       accept_rate=_accept_rate(state,
                                                burn_in + n_samples * thin))


def sample_chains(step: TransitionKernel, init_states, key, n_samples: int,
                  n_chains: int, *, burn_in: int = 0, thin: int = 1,
                  collect: Callable[[Any], Any] = lambda s: s,
                  sequential: bool = False) -> ChainResult:
    """Run ``n_chains`` independent chains back to back, each on its own
    generator drawn from ``key`` (an int seed or a ``torch.Generator``)
    on the states' device. ``init_states`` is one state (every chain
    starts there) or a tree stacked along a leading chains axis. Results
    have shape ``(n_chains, n_samples, ...)``. ``sequential`` (the JAX
    package's choice between vmap and lax.map) is accepted and ignored:
    chains here always run back to back."""
    del sequential
    tensors = _tensors(init_states)
    stacked = bool(tensors) and all(t.shape[:1] == (n_chains,)
                                    for t in tensors)
    gens = generators(key, n_chains, tensors[0].device)
    runs = [sample(step, index(init_states, c) if stacked else init_states,
                   gens[c], n_samples, burn_in=burn_in, thin=thin,
                   collect=collect) for c in range(n_chains)]
    return stack(runs)


def _accept_rate(state, n_steps: int):
    accepted = getattr(state, "accepted", None)
    if accepted is None:
        return torch.tensor(float("nan"))
    return accepted / n_steps
