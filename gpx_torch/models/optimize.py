"""Type-II maximum-likelihood / MAP hyperparameter optimization — the port
of ``gpx/models/optimize.py``.

The search runs on a flat vector in the unconstrained space of each
parameter's bijector and reports the optimum constrained. Each step makes
one logML + gradient call of the chosen route: ``method="analytic"`` is the
fused route on the card (:func:`gpx_torch.models.gp.
log_marginal_likelihood_analytic_vjp`), ``"hybrid"`` the fixed-probe
hybrid, ``"autodiff"`` autograd through the Cholesky and ``"iterative"``
the matrix-free estimate with fresh probes each step.

Differences from the JAX package, by design of the port:
- The loop is a Python loop of ``torch.optim`` steps, not one compiled
  ``lax.scan``. ``optimizer="adam"`` is ``torch.optim.Adam``, whose update
  is ``optax.adam``'s (bias-corrected moments, ``eps`` outside the square
  root, 0.9 / 0.999 / 1e-8), so the two agree step for step.
  ``optimizer="lbfgs"`` is ``torch.optim.LBFGS`` with a strong-Wolfe line
  search, one iteration per step; its first step and line search differ
  from optax's zoom, so the two agree at the optimum, not step by step.
- A step whose line search finds no step restarts the L-BFGS memory
  (steepest descent next), where torch's L-BFGS would repeat the same
  direction and search at every later step. In float32, components whose
  gradient is inside its rounding noise (h at N = 16,384 on the card)
  can spoil a direction and its line search while others still carry
  signal.
- ``torch.optim.LBFGS`` evaluates its closure at the start of every step,
  at the point where the previous line search already evaluated it; the
  closure here returns the cached value and gradient there, so a step
  costs the evaluations of its line search and no more (optax's
  ``value_and_grad_from_state``). Its strong-Wolfe line search compares
  values only; the closure gives it optax's approximate Wolfe test where
  the values stop resolving a decrease (:class:`_LineSearchObjective`).
- ``key`` is an int seed or a ``torch.Generator``. The iterative route
  draws ``steps + 1`` seeds from it and gives each step (and the final
  evaluation) a generator of its own on the data's device.
- ``chunk_steps`` bounds one compiled program's run time on the TPU; the
  port compiles nothing, so it is accepted and ignored. ``mesh=`` raises
  ``NotImplementedError``: the distributed likelihood is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from gpx_torch._device import full_fp32, generators, seeds
from gpx_torch.models import gp
from gpx_torch.ops.distance import check_xy
from gpx_torch.params import (
    Parameters, constrain, leaves, unconstrain, unflatten, unraveler,
)


class OptimizeResult(NamedTuple):
    """Outcome of :func:`optimize`.

    ``params`` are on the constrained (natural) scale. ``value`` is the
    final objective on the log scale being maximized (logML, plus the log
    prior for MAP) at the returned point; ``values`` the per-step trace of
    that quantity at each step's starting point; ``grad_norm`` the final
    unconstrained-space gradient norm; ``converged`` a Python bool: the
    final value finite and ``grad_norm < grad_tol``."""

    params: Parameters
    value: torch.Tensor
    values: torch.Tensor
    grad_norm: torch.Tensor
    converged: bool


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh= (the distributed likelihood) is "
                                  "not ported")


def optimize(params: Parameters, x, y, *, nugget: float = gp.LOGML_NUGGET,
             log_prior: Optional[Callable[[Parameters], torch.Tensor]] = None,
             steps: int = 100, optimizer: str = "lbfgs",
             learning_rate: float = 0.05, method: str = "analytic",
             grad_tol: float = 1e-3, history_size: int = 10, mesh=None,
             mesh_axis: str = "data", panel: int = 128, key=None,
             n_probes: int | None = None, lanczos_iters: int = 32,
             precond_rank: int = 0, deflate: int | None = None,
             chunk_steps: int | None = None) -> OptimizeResult:
    """Maximize the exact-GP marginal likelihood over hyperparameters.

    ``log_prior`` (a function of constrained :class:`Parameters`) turns
    MLE into MAP. ``optimizer`` is ``"lbfgs"`` or ``"adam"``
    (``learning_rate`` applies). ``method`` selects the route of every
    evaluation (module docstring); ``"hybrid"`` (``n_probes`` probes drawn
    once from ``key``, ``deflate``) and ``"iterative"`` (``n_probes``,
    ``lanczos_iters``, ``precond_rank``; fresh probes per step) need
    ``optimizer="adam"``, as in the JAX package: the hybrid's probe logdet
    correction can return finite garbage values on an ill-conditioned K,
    and the iterative values are noisy, and a line search compares values.

    The template's leaves are cast to the data's dtype and device before
    flattening. A non-finite objective becomes ``+inf`` (the line search
    then backtracks) and non-finite gradient entries are zeroed before the
    update; ``grad_norm`` is the raw norm, so a NaN shows. ``x`` and ``y``
    go to the card unless they are tensors elsewhere."""
    x, y = check_xy(x, y)
    if optimizer not in ("lbfgs", "adam"):
        raise ValueError(f"unknown optimizer: {optimizer!r}")
    if n_probes is None:
        # the hybrid's probe envelope is documented at 64; the iterative
        # estimator redraws its probes every step, so 16 suffice there
        n_probes = 64 if method == "hybrid" else 16

    bij = params.bijectors()
    u0 = unconstrain(bij, params)
    if x.is_floating_point():
        u0 = unflatten(u0, [t.to(dtype=x.dtype, device=x.device)
                            for t in leaves(u0)])
    flat0, unravel = unraveler(u0)

    step_keys = None
    if method == "iterative":
        if optimizer != "adam":
            raise ValueError(
                "method='iterative' has stochastic (SLQ/Hutchinson) "
                "gradients — use optimizer='adam'; a line search cannot "
                "compare noisy objective values")
        _no_mesh(mesh)
        loglik = _iterative_loglik_vjp(
            x, y, nugget=nugget, n_probes=n_probes,
            lanczos_iters=lanczos_iters, precond_rank=precond_rank,
            mesh=mesh, mesh_axis=mesh_axis)
        step_keys = generators(0 if key is None else key, steps + 1,
                               x.device)
    elif mesh is not None:
        _no_mesh(mesh)
    elif method == "analytic":
        loglik = gp.log_marginal_likelihood_analytic_vjp(x, y, nugget=nugget)
    elif method == "hybrid":
        if optimizer != "adam":
            raise ValueError(
                "method='hybrid' requires optimizer='adam': the probe-"
                "estimated logdet correction can return finite GARBAGE "
                "values on ill-conditioned K, and a line search latches "
                "onto them as huge improvements")
        loglik = gp.log_marginal_likelihood_hybrid_vjp(
            x, y, nugget=nugget, probes=n_probes,
            probe_key=_probe_generator(key, x.device), deflate=deflate)
    elif method == "autodiff":
        def loglik(p):
            return gp.log_marginal_likelihood(p, x, y, nugget=nugget)
    else:
        raise ValueError(f"unknown method: {method!r}")

    def objective(uflat, gen=None):
        p = constrain(bij, unravel(uflat))
        val = loglik(p) if gen is None else loglik(p, gen)
        if log_prior is not None:
            val = val + log_prior(p)
        # +inf (not NaN) on failure: the line search compares against the
        # current value and shrinks the step; NaN fails every comparison
        return torch.where(torch.isfinite(val), -val, math.inf)

    return _run_flat_opt(
        objective, flat0, bij, unravel, optimizer=optimizer, steps=steps,
        learning_rate=learning_rate, history_size=history_size,
        grad_tol=grad_tol, step_keys=step_keys, chunk_steps=chunk_steps)


def _probe_generator(key, device):
    """The hybrid's probe generator: ``None`` (a generator seeded 0 in
    :func:`gp.log_marginal_likelihood_hybrid_vjp`), an int seed, or a
    ``torch.Generator``."""
    if key is None or isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


def optimize_log_density(template, log_density: Callable, *,
                         steps: int = 100, optimizer: str = "lbfgs",
                         learning_rate: float = 0.05, grad_tol: float = 1e-3,
                         history_size: int = 10,
                         step_keys: Sequence | None = None) -> OptimizeResult:
    """Maximize any log density over a parameter tree with a
    ``bijectors()`` method, in its unconstrained space: the generic core
    of :func:`optimize`, and the deterministic counterpart of handing the
    same ``(template, log_density)`` to the samplers.

    ``step_keys`` (``steps + 1`` generators or int seeds): for stochastic
    log densities, ``log_density(p, generator)`` gets a fresh one per step
    and the last at the final evaluation; it needs ``optimizer="adam"``."""
    if optimizer not in ("lbfgs", "adam"):
        raise ValueError(f"unknown optimizer: {optimizer!r}")
    if step_keys is not None and optimizer != "adam":
        raise ValueError(
            "step_keys (stochastic log density) requires optimizer='adam'")
    bij = template.bijectors()
    flat0, unravel = unraveler(unconstrain(bij, template))
    if step_keys is not None:
        step_keys = [k if isinstance(k, torch.Generator) else
                     torch.Generator(device=flat0.device).manual_seed(int(k))
                     for k in step_keys]

    def objective(uflat, gen=None):
        p = constrain(bij, unravel(uflat))
        val = log_density(p) if gen is None else log_density(p, gen)
        return torch.where(torch.isfinite(val), -val, math.inf)

    return _run_flat_opt(
        objective, flat0, bij, unravel, optimizer=optimizer, steps=steps,
        learning_rate=learning_rate, history_size=history_size,
        grad_tol=grad_tol, step_keys=step_keys)


def _value_and_grad(objective, uflat, gen=None):
    """``(objective, d objective / du)`` at ``uflat``, both detached;
    always with gradients on, so every value comes from one route."""
    u = uflat.detach().requires_grad_()
    with torch.enable_grad():
        value = objective(u, gen)
        (grad,) = torch.autograd.grad(value, u)
    return value.detach(), grad


class _LineSearchObjective:
    """The L-BFGS closure's values and gradients, one evaluation per point:
    the objective is deterministic, so a point met again (the line
    search's last trial, where the next step starts; a trial repeated
    after a step that could not move) is served from the cache, keyed by
    the point's values.

    What the line search sees, from the step's start ``(u0, f0, g0)``:
    - where a trial's value ``f`` lies within ``rtol * |f0|`` above
      ``f0`` (it may lie below by any amount), the trapezoid value ``f0 +
      (g0 + g) . (u - u0) / 2``, in float64. Its Armijo test is then the
      approximate Wolfe condition of Hager and Zhang, ``phi'(t) <= (2 c1
      - 1) phi'(0)``, which optax's zoom line search takes on the same
      test: a decrease that the values' rounding hides still shows in the
      gradients. ``rtol`` is optax's default, 1e-6, in float64, and 1e-3
      in float32, ten times the relative error the fused route's float32
      value is held to (the JAX package's f32 envelope, 1e-4);
    - where ``f`` is not finite, ``f0 + |g0 . (u - u0)|``, a finite rise as
      steep as the fall the start's slope predicts: torch's cubic
      interpolation then backtracks to about a ninth of the step, where
      on ``+inf`` it would take ``inf - inf``, a NaN step.
    The trace keeps the true values."""

    def __init__(self, objective):
        self.objective = objective
        self.points: dict = {}
        self.origin = None

    def __call__(self, u):
        key = tuple(u.tolist())
        if key not in self.points:
            self.points[key] = _value_and_grad(self.objective, u)
        return self.points[key]

    def start(self, u):
        """Begin a step at ``u``; returns its value."""
        value, grad = self(u)
        self.origin = (u.clone(), value, grad)
        return value

    def for_line_search(self, u):
        value, grad = self(u)
        u0, f0, g0 = self.origin
        if not bool(torch.isfinite(f0)):
            return value, grad
        # in float64: a float32 sum would round the trapezoid's decrease,
        # a few ulps of f0 or less, back to f0
        f0, du = f0.double(), (u - u0).double()
        if not bool(torch.isfinite(value)):
            return f0 + torch.abs(torch.dot(_finite(g0).double(), du)), grad
        rtol = _APPROX_DEC_RTOL[value.dtype == torch.float64]
        if bool(value <= f0 + rtol * torch.abs(f0)):
            return f0 + 0.5 * torch.dot((g0 + _finite(grad)).double(),
                                        du), grad
        return value, grad


# the relative rise of the value within which the approximate Wolfe
# condition decides, indexed by "float64": optax's default, 1e-6, there,
# and ten times the float32 value's envelope, 1e-3, in float32
_APPROX_DEC_RTOL = (1e-3, 1e-6)
_MAX_LINE_SEARCH = 25  # trials per line search (torch's strong-Wolfe default)


def _finite(grad):
    return torch.where(torch.isfinite(grad), grad, 0.0)


def _run_flat_opt(objective, flat0, bij, unravel, *, optimizer, steps,
                  learning_rate, history_size, grad_tol, step_keys,
                  chunk_steps=None):
    """The optimizer loop on a flat unconstrained vector: ``steps`` steps
    of one ``torch.optim`` ``step()`` each, whatever the optimizer's own
    tolerances say. ``step_keys`` (``steps + 1`` generators) feeds a fresh
    generator to a stochastic objective at each step and the last to the
    final evaluation; ``chunk_steps`` is ignored (module docstring)."""
    del chunk_steps
    full_fp32()
    u = flat0.detach().clone().requires_grad_()
    vals = []
    if optimizer == "lbfgs":
        cache = _LineSearchObjective(objective)
        # max_eval bounds the closure calls of one step, the cached one at
        # its start included: 1 + the line search's 25 trials (torch's
        # default bound of 5/4 of max_iter would leave it none)
        opt = torch.optim.LBFGS([u], lr=1.0, max_iter=1, tolerance_grad=0.0,
                                tolerance_change=0.0,
                                max_eval=1 + _MAX_LINE_SEARCH,
                                history_size=history_size,
                                line_search_fn="strong_wolfe")

        def closure():
            value, grad = cache.for_line_search(u.detach())
            u.grad = _finite(grad)
            return value

        for _ in range(steps):
            start = u.detach().clone()
            vals.append(cache.start(start))
            opt.step(closure)
            if torch.equal(u.detach(), start):
                # the line search found no step: restart from steepest
                # descent, since torch's L-BFGS would repeat that search
                opt.state.clear()
        final_value, final_grad = cache(u.detach())
    else:
        opt = torch.optim.Adam([u], lr=learning_rate)
        for i in range(steps):
            gen = None if step_keys is None else step_keys[i]
            value, grad = _value_and_grad(objective, u, gen)
            vals.append(value)
            u.grad = _finite(grad)
            opt.step()
        # the final value and gradient at the returned iterate
        final_value, final_grad = _value_and_grad(
            objective, u, None if step_keys is None else step_keys[-1])

    u_final = u.detach()
    final_gnorm = torch.linalg.vector_norm(final_grad)
    converged = (bool(torch.isfinite(final_value))
                 and bool(final_gnorm < grad_tol))
    empty = flat0.new_empty((0,))
    return OptimizeResult(
        params=constrain(bij, unravel(u_final)),
        value=-final_value,
        values=-torch.stack(vals) if vals else empty,
        grad_norm=final_gnorm,
        converged=converged,
    )


def stochastic_log_density_vjp(run):
    """Wrap ``run(params, generator) -> result`` (anything with ``.value``
    and ``.grads``, e.g. the iterative logML estimator) into
    ``f(params, generator) -> value`` whose autograd gradient is
    ``result.grads`` times the incoming gradient: the glue that lets
    autograd consume estimators that package their own gradients. The
    generator parameterizes the estimator, not the model, and gets no
    gradient."""

    def f(params, generator):
        def value_and_grad(p):
            res = run(p, generator)
            return res.value, res.grads

        return gp._scalar_vjp(value_and_grad)(params)

    return f


def _iterative_loglik_vjp(x, y, *, nugget, n_probes, lanczos_iters,
                          precond_rank, mesh, mesh_axis):
    """``(params, generator) -> logML estimate`` whose autograd gradient is
    the matrix-free Hutchinson estimate of
    ``gp_iterative.logml_value_and_grad_iterative`` (CG-exact quadratic
    term, SLQ logdet, probes drawn from the generator)."""
    from gpx_torch.models.gp_iterative import logml_value_and_grad_iterative

    def run(p, gen):
        return logml_value_and_grad_iterative(
            p, x, y, gen, nugget=nugget, n_probes=n_probes,
            lanczos_iters=lanczos_iters, precond_rank=precond_rank,
            mesh=mesh, mesh_axis=mesh_axis)

    return stochastic_log_density_vjp(run)
