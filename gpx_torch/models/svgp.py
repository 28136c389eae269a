"""Stochastic variational GP (SVGP): uncollapsed, minibatched inducing-point
regression (Hensman et al., "Gaussian Processes for Big Data", 2013) — the
port of ``gpx/models/svgp.py``.

The model carries a variational posterior ``q(u) = N(mu, S)`` over the
inducing outputs, so each optimizer step touches one minibatch (O(B M^2))
and the bound is an unbiased estimate of the full ELBO. Whitened
parameterization: ``u = Luu v``, ``q(v) = N(mu, S)`` with ``S = C C^T`` for
a lower-triangular ``C`` kept unconstrained as ``c_raw`` (strict lower
triangle free, diagonal through ``exp``); KL(q || p) is then the standard
normal form ``0.5 (||mu||^2 + tr(S) - logdet S - M)``.

On the card, in float32, ``Kuu`` and ``K(z, x_b)`` come from the CUDA Gram
kernel; the factor and the solves are ``torch.linalg``'s.

Differences from the JAX package, by design of the port:
- The solver for ``Luu^-1 K(z, x)`` is the argument ``solver`` (``"solve"``,
  a triangular solve; ``"inv"``, the explicit inverse by
  :func:`gpx_torch.ops.chol.tri_inverse_lower` and one product), where the
  JAX package reads ``GPX_SVGP_SOLVER`` from the environment.
- :func:`train` is ``torch.optim.Adam`` in a Python loop (whose update is
  ``optax.adam``'s) over minibatches drawn by :func:`_batch_indices` from a
  ``torch.Generator``, where the JAX package scans ``optax.adam`` over
  ``jax.random`` draws; the draws differ. With ``mesh=`` each rank draws
  from its own generator, seeded from ``key`` by its coordinate, where the
  JAX package folds the coordinate into the step's key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpx_torch._device import as_tensor, full_fp32, resolve_device
# the Kuu regularization policy has one source: gpx_torch.models.sparse
from gpx_torch.models.sparse import JITTER, JITTER_F32, _jitter  # noqa: F401
from gpx_torch.ops.chol import cholesky, forward_solve, tri_inverse_lower
from gpx_torch.ops.distance import as_locations
from gpx_torch.params import Parameters, constrain, leaves, unconstrain, unflatten


class SVGPState(NamedTuple):
    """Variational state: whitened mean and unconstrained Cholesky factor."""

    mu: torch.Tensor      # (M,)
    c_raw: torch.Tensor   # (M, M); tril(-1) free, diag through exp


def init_state(m: int, dtype=torch.float32, *, device=None) -> SVGPState:
    """q(v) = N(0, I), the whitened prior (zero KL), on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    return SVGPState(mu=torch.zeros((m,), dtype=dtype, device=dev),
                     c_raw=torch.zeros((m, m), dtype=dtype, device=dev))


def _c_factor(c_raw):
    """``C`` from ``c_raw`` (also for a stack of them on leading axes)."""
    return torch.tril(c_raw, -1) + torch.diag_embed(
        torch.exp(torch.diagonal(c_raw, dim1=-2, dim2=-1)))


def _whitened_features(params: Parameters, z, xb, solver: str = "solve"):
    """``(a, Luu)``: the columns ``a_i = Luu^-1 k(z, x_i)`` for a batch,
    (M, B). ``solver="inv"`` applies the explicit ``Luu^-1`` as one product
    (the JAX package measured it slower than the solve at M = 1024 on its
    TPU, and ~6e-5 relative ELBO accuracy lost); ``"solve"`` is the
    triangular solve."""
    if solver not in ("solve", "inv"):
        raise ValueError(f"unknown solver: {solver!r}")
    full_fp32()
    z = as_locations(z)
    kuu = params.kernel.gram(z, nugget=_jitter(z.dtype))
    luu = cholesky(kuu)
    kuf = params.kernel.gram(z, xb)
    if solver == "inv":
        return tri_inverse_lower(luu) @ kuf, luu
    return forward_solve(luu, kuf), luu


def kl(state: SVGPState):
    """KL(q(v) || N(0, I)) in the whitened space."""
    c = _c_factor(state.c_raw)
    m = state.mu.shape[0]
    return 0.5 * (state.mu @ state.mu + torch.sum(c * c)
                  - 2.0 * torch.sum(torch.diagonal(state.c_raw)) - m)


def _moments(params, z, state, xs, solver):
    """Predictive mean and variance of q(f) at ``xs``."""
    a, _ = _whitened_features(params, z, xs, solver)
    c = _c_factor(state.c_raw)
    mean = params.mean(xs) + a.T @ state.mu
    kss = params.kernel.diag(xs, dtype=mean.dtype)
    # full float32: a variance, as a sum of squares
    var = kss - torch.sum(a * a, dim=0) + torch.sum((c.T @ a) ** 2, dim=0)
    return mean, var


def elbo_minibatch(params: Parameters, z, state: SVGPState, xb, yb, *,
                   n_total: int, noise, solver: str = "solve"):
    """Unbiased ELBO estimate from one minibatch (Gaussian likelihood).

    ``E_q[log p(y_i | f_i)]`` is closed-form: with ``m_i = a_i^T mu + mean``
    and ``v_i = k_ii - ||a_i||^2 + ||C^T a_i||^2``,
    ``-0.5 log(2 pi s2) - ((y_i - m_i)^2 + v_i) / (2 s2)``, scaled by
    ``n_total / B``, minus the (full) KL."""
    xb = as_locations(xb)
    yb = as_tensor(yb, device=xb.device)
    b = xb.shape[0]
    mean_b, var_b = _moments(params, z, state, xb, solver)
    s2 = torch.as_tensor(noise, dtype=mean_b.dtype, device=mean_b.device)
    exp_ll = -0.5 * torch.log(2.0 * math.pi * s2) - 0.5 * (
        (yb - mean_b) ** 2 + var_b) / s2
    return (n_total / b) * torch.sum(exp_ll) - kl(state)


class SVGPSummary(NamedTuple):
    x: torch.Tensor
    mean: torch.Tensor
    variance: torch.Tensor


def fit(params: Parameters, z, state: SVGPState, xs, *, noise=0.0,
        solver: str = "solve") -> SVGPSummary:
    """Predictive q(f*) (add ``noise`` for the observation predictive)."""
    xs = as_locations(xs)
    mean, var = _moments(params, z, state, xs, solver)
    return SVGPSummary(x=xs, mean=mean,
                       variance=torch.clamp_min(var, 0.0) + noise)


def _batch_indices(gen, n: int, b: int, device):
    """``b`` distinct indices of ``range(n)`` drawn with ``gen``, on
    ``device``: one minibatch of :func:`train`."""
    return torch.randperm(n, generator=gen, device=gen.device)[:b].to(device)


def _generator(key, device):
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def _train(key, params, z, x, state, noise0, elbo, *, batch_size: int,
           steps: int, learning_rate: float, train_inducing: bool,
           train_hyper: bool, train_noise: bool, mesh=None,
           mesh_axis: str = "data"):
    """``steps`` Adam steps on ``elbo(params, z, state, idx, noise)``, the
    ELBO of the minibatch of rows ``idx``, over the variational state, the
    hyperparameters (through their bijectors, in unconstrained space), the
    inducing locations and the noise (on the log scale), as far as each is
    trained. Each step draws its minibatch by :func:`_batch_indices` from
    ``key`` (an int seed or a ``torch.Generator``). The trace holds each
    step's ELBO at its start, read to the host at the end only. With a
    mesh, ``x`` and ``elbo`` are this rank's shard's, and each step's
    gradients and ELBO are averaged over ``mesh[mesh_axis]`` (one ``psum``
    a step) before the update, which every rank then takes alike.

    Returns ``(params, z, state, noise, elbo_trace)``, detached."""
    gen = _generator(key, x.device)
    bijs = params.bijectors()
    u_params = unconstrain(bijs, params)

    def var(t):
        return t.detach().clone().requires_grad_()

    st = type(state)(*(var(t) for t in state))
    u_leaves = [var(t) for t in leaves(u_params)] if train_hyper else []
    zz = var(z) if train_inducing else z
    log_noise = var(torch.log(noise0)) if train_noise else None
    tensors = [*st, *u_leaves] + ([zz] if train_inducing else []) + (
        [log_noise] if train_noise else [])

    def current():
        p = (constrain(bijs, unflatten(u_params, u_leaves)) if train_hyper
             else params)
        return p, (torch.exp(log_noise) if train_noise else noise0)

    opt = torch.optim.Adam(tensors, lr=learning_rate)
    trace = []
    for _ in range(steps):
        idx = _batch_indices(gen, x.shape[0], batch_size, x.device)
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            p, s2 = current()
            loss = -elbo(p, zz, st, idx, s2)
            loss.backward()
        if mesh is not None:
            loss = _average(mesh, mesh_axis, tensors, loss.detach())
        opt.step()
        trace.append(-loss.detach())
    with torch.no_grad():
        p, s2 = current()
    return (unflatten(p, [t.detach() for t in leaves(p)]), zz.detach(),
            type(state)(*(t.detach() for t in st)), s2.detach(),
            torch.stack(trace) if trace else x.new_zeros((0,)))


def _average(mesh, mesh_axis, tensors, loss):
    """Each tensor's gradient and ``loss`` replaced by their means over
    ``mesh[mesh_axis]`` (the JAX package's ``pmean`` of the ranks'
    likelihood terms: the KL, replicated, passes through unchanged);
    returns the mean loss."""
    from gpx_torch.parallel import comm

    d = comm.axis_size(mesh, mesh_axis)
    sums = comm.psum_each([torch.zeros_like(t) if t.grad is None else t.grad
                           for t in tensors] + [loss], mesh, mesh_axis)
    for t, g in zip(tensors, sums):
        t.grad = g / d
    return sums[-1] / d


def train(key, params: Parameters, z, x, y, *, noise, batch_size: int = 256,
          steps: int = 1000, learning_rate: float = 1e-2,
          train_inducing: bool = True, train_hyper: bool = True,
          train_noise: bool = False, mesh=None, mesh_axis: str = "data",
          solver: str = "solve"):
    """Adam on the minibatch ELBO over the variational state, the
    hyperparameters (through their bijectors, in unconstrained space), the
    inducing locations and, optionally, the observation noise (on the log
    scale). ``key`` is an int seed or a ``torch.Generator`` for the
    minibatch draws.

    ``mesh=`` trains data-parallel over ``mesh[mesh_axis]``: every rank
    passes the whole ``x`` and ``y`` and works on its block of rows, draws
    ``batch_size / d`` points of it a step (``batch_size`` is the global
    batch), and the ranks' likelihood estimates are averaged (one ``psum``
    a step: the variational state, the hyperparameters and the optimizer
    state stay replicated). Each rank's ``(N / B_loc) sum_local`` estimates
    the full-data likelihood from its shard, so the average is the
    single-device estimator of the union of the ranks' minibatches.

    Returns ``(params, z, state, noise, elbo_trace)``."""
    full_fp32()
    x = as_locations(x)
    z = as_locations(z)
    y = as_tensor(y, device=x.device)
    n_total = x.shape[0]
    if mesh is not None:
        from gpx_torch._device import seeds
        from gpx_torch.parallel import comm

        d = comm.axis_size(mesh, mesh_axis)
        if n_total % d or batch_size % d:
            raise ValueError(
                f"data-parallel SVGP needs n ({n_total}) and batch_size "
                f"({batch_size}) divisible by the {d}-device mesh axis")
        my = comm.axis_index(mesh, mesh_axis)
        n_loc = n_total // d
        x, y = x[my * n_loc:(my + 1) * n_loc], y[my * n_loc:(my + 1) * n_loc]
        key = seeds(key, d)[my]
        batch_size //= d

    def elbo(p, zz, state, idx, s2):
        return elbo_minibatch(p, zz, state, x[idx], y[idx], n_total=n_total,
                              noise=s2, solver=solver)

    return _train(key, params, z, x,
                  init_state(z.shape[0], dtype=x.dtype, device=x.device),
                  torch.as_tensor(noise, dtype=x.dtype, device=x.device),
                  elbo, batch_size=batch_size, steps=steps,
                  learning_rate=learning_rate, train_inducing=train_inducing,
                  train_hyper=train_hyper, train_noise=train_noise,
                  mesh=mesh, mesh_axis=mesh_axis)
