"""Gaussian-process marginal likelihood, its gradient, prediction and
prior and posterior draws — the port of ``gpx/models/gp.py``.

``logml_value_and_grad(params, x, y)`` with ``method="analytic"`` is the
path every user of the library reaches (samplers call it once per leapfrog
step, type-II MLE once per step). On the card, in float32, for a kernel the
CUDA device functions support (or one top-level ``Ard`` over such a
kernel) and ``n >= FUSED_MIN_N``, it runs the fused route: the Gram
kernel, ``chol_inv`` over the leaf and product kernels, and the fused
gradient kernel. Everything else takes the non-fused route on
``torch.linalg``. A Gram that is not positive definite gives NaN on every
route, as in the JAX package, and ``-inf`` from
``log_marginal_likelihood(safe=True)``.

``method="hybrid"`` factors with the trailing-spine M21 blocks skipped,
solves alpha and a Rademacher probe block through that factor, and
estimates the trace term of the gradient with the probe kernel, deflated by
a pivoted-Cholesky basis (:func:`_logml_value_and_grad_hybrid`).

:func:`log_marginal_likelihood_analytic_vjp` and
:func:`log_marginal_likelihood_hybrid_vjp` package these as scalar
functions whose autograd gradient is the analytic (or hybrid) one: the
samplers of :mod:`gpx_torch.infer` differentiate through them.

:func:`fit` is the posterior at test points (GPML Algorithm 2.1, batched).
Under the same gate as the fused logML it runs the CUDA kernels: the Gram
on K and on the cross block, ``chol_inv``, and one ``left_lower`` trmm for
the variance; else ``torch.linalg``. :func:`draw` and
:func:`posterior_draw` take a ``torch.Generator`` where the JAX package
takes a key.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gpx_torch._device import as_tensor, full_fp32
from gpx_torch.distributions import normal_interval
from gpx_torch.ops.chol import (
    add_jitter, back_solve, cholesky, forward_solve, spd_inverse_from_chol,
)
from gpx_torch.kernels import Ard, Sum, has_white, split_noise, table_miss
from gpx_torch.ops.cuda_chol import (
    LEAF, chol_inv, spine_solve_lower, spine_solve_lower_t,
)
from gpx_torch.ops.cuda_logml_grad import (
    TILE, logml_kernel_grads, logml_probe_grads,
)
from gpx_torch.ops.cuda_trmm import trmm
from gpx_torch.ops.distance import as_locations, check_xy
from gpx_torch.ops.gram import gram, uses_cuda_kernel
from gpx_torch.params import Parameters, from_array, leaves, unflatten

DRAW_NUGGET = 1e-3  # the reference's draw nugget (GaussianProcess.scala:71)
LOGML_NUGGET = 1e-3  # the reference's Tikhonov nugget (GaussianProcess.scala:117)
PREDICT_NUGGET = 1e-6  # the reference's prediction nugget (Predict.scala:67)

# Smallest n that takes the fused route: chip_smoke.py times both routes
# at n = 1024 ... 16384 on the card. On an H100 (700 W), with the factor's
# products on the tensor cores, the fused route lost at 2048 and won from
# 4096 on (PERF.md, PR 4).
FUSED_MIN_N = 4096

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class PosteriorSummary(NamedTuple):
    """Marginal posterior at test locations (the reference's
    ``Vector[(Location, Gaussian)]``, Predict.scala:61)."""

    x: torch.Tensor         # (M, D) test locations
    mean: torch.Tensor      # (M,)
    variance: torch.Tensor  # (M,)

    def interval(self, q):
        """Credible bound at quantile ``q`` (Summarise.getInterval)."""
        return normal_interval(self.mean, self.variance, q)


def sample_points(key, start, end, n: int):
    """Sorted uniform 1-D design points on ``key``'s device
    (GaussianProcess.samplePoints)."""
    u = torch.rand(n, generator=key, device=key.device)
    return torch.sort(start + (end - start) * u).values


def draw(key, params: Parameters, x, *, nugget: float = DRAW_NUGGET, shape=()):
    """Draw from the GP prior at ``x``: ``mu + z L^T`` with ``L`` the
    Cholesky factor of ``K + nugget I`` and ``z`` standard normal from the
    generator ``key`` (on ``x``'s device), of shape ``(*shape, N)``."""
    full_fp32()
    x = as_locations(x)
    l = cholesky(params.kernel.gram(x, nugget=nugget))
    z = torch.randn((*shape, x.shape[0]), generator=key, dtype=l.dtype,
                    device=l.device)
    return params.mean(x) + z @ l.T


def log_marginal_likelihood(params: Parameters, x, y, *,
                            nugget: float = LOGML_NUGGET, safe: bool = False):
    """Exact GP marginal log-likelihood: Gram + nugget, one Cholesky, one
    forward solve. NaN where the Gram is not positive definite;
    ``safe=True`` escalates the nugget on a failed factor
    (:func:`gpx_torch.ops.safe_chol.safe_cholesky`) and returns ``-inf``
    when even the largest fails, so that a sampler rejects the move."""
    full_fp32()
    x, y = check_xy(x, y)
    n = x.shape[0]
    kxx = gram(params.kernel, x, nugget=nugget)
    if safe:
        from gpx_torch.ops.safe_chol import safe_cholesky

        result = safe_cholesky(kxx)
        l = result.chol
    else:
        l = cholesky(kxx)
    u = forward_solve(l, y - params.mean(x))
    half_logdet = torch.sum(torch.log(torch.diagonal(l)))
    value = -0.5 * (u @ u) - half_logdet - n * _HALF_LOG_2PI
    if safe:
        value = torch.where(result.failed, float("-inf"), value)
    return value


def _grads_or_zeros(outputs, inputs, grad_outputs=None):
    if not inputs:
        return []
    grads = torch.autograd.grad(outputs, inputs, grad_outputs,
                                allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(inputs, grads)]


def logml_value_and_grad(params: Parameters, x, y, *,
                         nugget: float = LOGML_NUGGET,
                         method: str = "analytic",
                         fast_gradients: bool = False,
                         probes: int = 64, probe_key=None,
                         deflate: int | None = None):
    """``(logML, d logML / d params)``, the gradient as a ``Parameters``
    tree of the same structure.

    ``method="analytic"`` uses the trace identity ``d logML/d theta =
    0.5 (alpha^T G alpha - tr(K^-1 G))``, ``G = dK/d theta`` (fused route
    on the card, see :func:`_fused_gate`); ``method="autodiff"`` runs
    torch autograd through the Cholesky factor.

    ``method="hybrid"`` estimates the trace term from ``probes`` Rademacher
    probes drawn from ``probe_key`` (a ``torch.Generator`` on ``x``'s
    device; ``None`` is a generator seeded 0, so repeated calls agree),
    deflated by a rank-``deflate`` basis (``None``: ``min(64, n // 32)``).
    It needs a stationary, Pallas-safe kernel; on the card, one the CUDA
    term table holds.

    ``fast_gradients=True`` runs the fused route's outermost M21 and its
    gradient contraction on the 2-pass leg (``chol_inv(fast=True)``,
    ``logml_kernel_grads(fast=True)``): about 2^-11 relative per product,
    and the value loosens with the logdet correction that shares it. Off
    the fused route (every CPU tensor) it is ignored and the result is
    bitwise the ``False`` one, as in the JAX package; ``method="hybrid"``
    and ``"autodiff"`` ignore it too."""
    full_fp32()
    if method == "hybrid":
        _hybrid_gate(params.kernel)
        x, y = check_xy(x, y)
        if probe_key is None:
            probe_key = torch.Generator(device=x.device).manual_seed(0)
        z = torch.randint(0, 2, (x.shape[0], probes), generator=probe_key,
                          device=x.device).mul_(2).sub_(1)
        return _logml_value_and_grad_hybrid(params, x, y, nugget, z=z,
                                            deflate=deflate)
    if method == "autodiff":
        ps = [t.detach().requires_grad_() for t in leaves(params)]
        with torch.enable_grad():
            value = log_marginal_likelihood(unflatten(params, ps), x, y,
                                            nugget=nugget)
            grads = _grads_or_zeros(value, ps)
        return value.detach(), unflatten(params, grads)
    if method != "analytic":
        raise ValueError(f"unknown method: {method}")
    return _logml_value_and_grad_analytic(params, x, y, nugget,
                                          fast_gradients=fast_gradients)


def _split_ard(kernel):
    """``(base, ell)`` for one top-level :class:`Ard` over a kernel that is
    not itself an ``Ard``; else ``(kernel, None)``."""
    if isinstance(kernel, Ard) and not isinstance(kernel.base, Ard):
        return kernel.base, kernel.ell
    return kernel, None


def _fused_gate(kernel, x) -> bool:
    """Whether the fused route applies: float32 on the card, ``n >=
    FUSED_MIN_N``, and a kernel the CUDA device functions support, after
    one top-level ``Ard`` is unwrapped (ARD is the base kernel on scaled
    coordinates). Any such ``n`` qualifies; :func:`_fused_logml_core` pads
    it."""
    return (uses_cuda_kernel(_split_ard(kernel)[0], x)
            and x.shape[0] >= FUSED_MIN_N)


def _pad_spd(k, pad: int):
    """Embed ``K`` in ``blockdiag(K, I_pad)``: its factor is
    ``blockdiag(L, I)`` and its inverse ``blockdiag(L^-1, I)``, exactly."""
    n = k.shape[-1]
    kp = F.pad(k, (0, pad, 0, pad))
    kp[n:, n:].fill_diagonal_(1.0)
    return kp


def _fused_logml_core(kernel, x, r, k_val, nugget: float, *,
                      base: int = LEAF, fast: bool = False):
    """The fused leg at any ``n``: returns ``(value, d_kernel, alpha)``;
    ``fast`` takes the 2-pass legs of ``chol_inv`` and the gradient kernel.

    ``n`` is padded to a multiple of the port's tiles (the gradient kernel's
    64 and the leaf size ``base``) with :func:`_pad_spd`; the residual pads
    with zeros and the coordinates with copies of ``x[0]``. The gradient
    contraction gets ``l_inv`` with its pad rows zeroed, so every pad entry
    meets an exactly-zero weight, and the logdet correction uses the real
    ``n``. A top-level ``Ard`` contracts its base kernel on the scaled
    coordinates ``x / ell`` and turns the per-dimension sums ``sdot`` into
    the lengthscale gradients ``-2 sdot / ell``. On CPU tensors every
    kernel call takes its plain version."""
    base_kernel, ell = _split_ard(kernel)
    n = x.shape[0]
    pad = (-n) % math.lcm(TILE, base)
    if pad:
        k_mat = _pad_spd(k_val, pad)
        r_vec = F.pad(r, (0, pad))
        x_c = torch.cat([x, x[:1].expand(pad, x.shape[1])])
    else:
        k_mat, r_vec, x_c = k_val, r, x

    l, l_inv = chol_inv(k_mat, base=base, fast=fast)
    del l
    # alpha through the explicit inverse plus one refinement step: the
    # inverse alone is backward-unstable, one K-matvec correction restores
    # solve-grade accuracy
    alpha0 = l_inv.T @ (l_inv @ r_vec)
    resid1 = r_vec - k_mat @ alpha0
    alpha = alpha0 + l_inv.T @ (l_inv @ resid1)
    quad = r_vec @ alpha
    # the pad diagonal of l_inv is exactly 1 and adds exactly 0 here
    log_diag = torch.sum(torch.log(torch.diagonal(l_inv)))

    if pad:
        # zero the pad rows in place: l_inv is not read again after this
        l_inv[n:] = 0.0
    if ell is None:
        d_kernel, (tkw, trw) = logml_kernel_grads(kernel, x_c, alpha, l_inv,
                                                  fast=fast)
    else:
        d_base, (tkw, trw), sdot = logml_kernel_grads(
            base_kernel, x_c / ell.to(x_c.dtype), alpha, l_inv, ard=True,
            fast=fast)
        d_kernel = Ard(base=d_base, ell=-2.0 * sdot / ell.to(sdot.dtype))

    # first-order logdet correction with W_hat = l_inv^T l_inv:
    # logdet K = -2 sum log diag(l_inv) + (tr(W_hat K) - n) + O(||E||^2)
    half_logdet = -log_diag + 0.5 * (tkw + nugget * trw - n)
    value = -0.5 * quad - half_logdet - n * _HALF_LOG_2PI
    return value, d_kernel, alpha[:n]


def _logml_value_and_grad_analytic(params: Parameters, x, y, nugget: float,
                                   *, fast_gradients: bool = False):
    x, y = check_xy(x, y)
    n = x.shape[0]
    ms = [t.detach().requires_grad_() for t in leaves(params.mean)]
    with torch.enable_grad():
        mean_val = unflatten(params.mean, ms)(x)
    r = y - mean_val.detach()

    if _fused_gate(params.kernel, x):
        k_val = gram(params.kernel, x, nugget=nugget)
        value, d_kernel, alpha = _fused_logml_core(
            params.kernel, x, r, k_val, nugget, fast=fast_gradients)
        d_kernel = unflatten(params.kernel, [
            g.to(leaf.dtype) for g, leaf in
            zip(leaves(d_kernel), leaves(params.kernel))
        ])
    else:
        ks = [t.detach().requires_grad_() for t in leaves(params.kernel)]
        with torch.enable_grad():
            k_val = gram(unflatten(params.kernel, ks), x, nugget=nugget)
        l = cholesky(k_val.detach())
        u = forward_solve(l, r)
        alpha = back_solve(l.T, u)
        half_logdet = torch.sum(torch.log(torch.diagonal(l)))
        value = -0.5 * (u @ u) - half_logdet - n * _HALF_LOG_2PI
        # explicit K^-1 and one gram VJP cover every hyperparameter
        w = 0.5 * (torch.outer(alpha, alpha) - spd_inverse_from_chol(l))
        d_kernel = unflatten(params.kernel, _grads_or_zeros(k_val, ks, w))
    d_mean = unflatten(params.mean,
                       _grads_or_zeros(mean_val, ms, alpha.to(mean_val.dtype)))
    return value, Parameters(mean=d_mean, kernel=d_kernel)


def _hybrid_gate(kernel) -> None:
    """Raise ``ValueError`` unless ``method="hybrid"`` takes ``kernel``: a
    stationary, Pallas-safe kernel, or one top-level ``Ard`` over one (as
    the JAX package)."""
    base, _ = _split_ard(kernel)
    if isinstance(base, Ard) or not base.is_stationary or not base.pallas_safe:
        raise ValueError(
            "method='hybrid' needs a stationary Pallas-safe kernel (a single "
            "top-level Ard wrapper is supported); use method='analytic'")


def _logml_value_and_grad_hybrid(params: Parameters, x, y, nugget: float, *,
                                 z, deflate: int | None = None,
                                 base: int = LEAF):
    """The hybrid logML and gradient with the ``(n, s)`` probe block ``z``.

    ``chol_inv(spine=True)`` skips the trailing-spine M21 blocks; alpha
    (with one refinement step) and the probe block are solved through the
    spine, and :func:`logml_probe_grads` estimates the trace term in
    O(n^2 s). With deflation (:func:`_hybrid_deflation`) a second probe
    contraction on the augmented block gives the gradients of the smooth
    leaves; the plain estimate gives the diagonal-supported leaves
    (:func:`_hybrid_diag_mask`) and both logdet-correction traces.

    ``n`` pads to a multiple of the tiles (:func:`_pad_spd`); ``z`` and
    alpha pad with zero rows, so every pad entry of the estimate is zero
    and no pad correction is needed. ``base`` is the factor's leaf size. A
    top-level ``Ard`` runs as in :func:`_fused_logml_core`: the base
    kernel on the scaled coordinates, deflated by the base's smooth part
    there, and ``-2 sdot / ell`` (from the deflated estimate) for the
    lengthscales. On the card this runs in float32 and needs a kernel the
    CUDA term table holds; on CPU tensors every kernel call takes its plain
    version."""
    x, y = check_xy(x, y)
    n = x.shape[0]
    kern = params.kernel
    base_kernel, ell = _split_ard(kern)
    if x.device.type == "cuda" and not base_kernel.cuda_supported:
        raise NotImplementedError(
            f"method='hybrid' on the card needs the CUDA term table to hold "
            f"this {type(base_kernel).__name__}: {table_miss(base_kernel)}")
    ms = [t.detach().requires_grad_() for t in leaves(params.mean)]
    with torch.enable_grad():
        mean_val = unflatten(params.mean, ms)(x)
    r = y - mean_val.detach()
    if x.device.type == "cuda":
        x, r = x.float(), r.float()
    k_val = gram(kern, x, nugget=nugget)

    pad = (-n) % math.lcm(TILE, base)
    if pad:
        k_mat = _pad_spd(k_val, pad)
        r_vec = F.pad(r, (0, pad))
        x_c = torch.cat([x, x[:1].expand(pad, x.shape[1])])
    else:
        k_mat, r_vec, x_c = k_val, r, x
    if ell is not None:
        x_c = x_c / ell.to(x_c.dtype)

    l, m = chol_inv(k_mat, base=base, spine=True)

    def solve(b):
        return spine_solve_lower_t(l, m, spine_solve_lower(l, m, b, base=base),
                                   base=base)

    alpha0 = solve(r_vec)
    alpha = alpha0 + solve(r_vec - k_mat @ alpha0)
    quad = r_vec @ alpha

    z = F.pad(z.to(k_mat.dtype), (0, 0, 0, pad))
    ard = ell is not None
    u_plain, aug = _hybrid_deflation(base_kernel, x_c, z, solve, n, deflate)
    d_base, (tkw, trw), *sdot = logml_probe_grads(base_kernel, x_c, alpha,
                                                  u_plain, z, ard=ard)
    grads = leaves(d_base)
    if aug is not None:
        d_defl, _, *sdot_defl = logml_probe_grads(base_kernel, x_c, alpha,
                                                  *aug, ard=ard)
        grads = [a if plain else b for plain, a, b in
                 zip(_hybrid_diag_mask(base_kernel), grads, leaves(d_defl))]
        sdot = sdot_defl  # the lengthscales are smooth: the deflated sums
    if ard:
        grads = grads + [-2.0 * sdot[0] / ell.to(sdot[0].dtype)]
    d_kernel = unflatten(kern, [g.to(leaf.dtype) for g, leaf in
                                zip(grads, leaves(kern))])
    # the pad diagonal of m is exactly 1 (log 0) and the estimated traces
    # cover the real block only, so the real n is the right constant
    half_logdet = (-torch.sum(torch.log(torch.diagonal(m)))
                   + 0.5 * (tkw + nugget * trw - n))
    value = -0.5 * quad - half_logdet - n * _HALF_LOG_2PI
    d_mean = unflatten(params.mean,
                       _grads_or_zeros(mean_val, ms, alpha[:n].to(mean_val.dtype)))
    return value, Parameters(mean=d_mean, kernel=d_kernel)


def _hybrid_diag_mask(kernel) -> list[bool]:
    """Per leaf of ``kernel`` (in :func:`leaves` order): True where its
    gradient contraction is diagonal-supported, for every leaf of a
    non-``Sum`` subtree that holds a White term. Those take the plain probe
    estimate; deflation raises their variance."""
    if isinstance(kernel, Sum):
        return [f for k in kernel.kernels for f in _hybrid_diag_mask(k)]
    return [has_white(kernel)] * len(leaves(kernel))


def _hybrid_deflation(kernel, x_c, z, solve, n: int, deflate: int | None):
    """``(u_plain, aug)``: ``u_plain = K^-1 z``, and ``aug = (u_aug,
    z_aug)`` (``None`` without deflation) such that the probe kernel's own
    normalization ``(U Z^T + Z U^T) / (2 s_aug)`` gives::

        Y~ Q^T + Q Y~^T  +  sym((I-P) K^-1 (I-P) Z Z^T) / s

    with ``Q`` an orthonormal rank-``k`` basis of the smooth part's range
    (pivoted Cholesky of the White-free kernel, then QR), ``P = Q Q^T``,
    ``Y = K^-1 Q`` and ``Y~ = Y - Q (Q^T Y) / 2``: the exact rank-k part of
    ``K^-1`` plus the Hutchinson estimate of the doubly deflated rest. The
    residual-probe columns are prescaled by ``s_aug / s`` and the exact
    columns by ``2 s_aug``. One solve covers the residual probes and
    ``Y``; ``u_plain = K^-1 (I-P) z + Y (Q^T z)`` needs no more."""
    s = z.shape[1]
    smooth, _ = split_noise(kernel)
    if deflate is None:
        deflate = 0 if smooth is None else min(64, n // 32)
    deflate = int(min(deflate, n))
    if deflate == 0 or smooth is None:
        return solve(z), None
    from gpx_torch.models.gp_iterative import pivoted_cholesky

    l_r = pivoted_cholesky(smooth, x_c[:n], deflate)
    q = F.pad(torch.linalg.qr(l_r.to(z.dtype))[0], (0, 0, 0, z.shape[0] - n))
    qtz = q.T @ z
    sol = solve(torch.cat([z - q @ qtz, q], dim=1))
    u_res, y = sol[:, :s], sol[:, s:]
    u_plain = u_res + y @ qtz
    u_res = u_res - q @ (q.T @ u_res)
    y_t = y - 0.5 * (q @ (q.T @ y))
    s_aug = s + deflate
    u_aug = torch.cat([u_res * (s_aug / s), (2.0 * s_aug) * y_t], dim=1)
    z_aug = torch.cat([z, q], dim=1)
    return u_plain, (u_aug, z_aug)


def log_marginal_likelihood_analytic_vjp(x, y, *,
                                         nugget: float = LOGML_NUGGET,
                                         fast_gradients: bool = False):
    """A ``params -> logML`` scalar function whose autograd gradient is the
    analytic one (:func:`logml_value_and_grad`, the fused route on the
    card) instead of autograd through the Cholesky: each leapfrog step of
    a sampler then makes one fused logML + gradient call. First order
    only. A call whose leaves need no gradient (or under ``no_grad``)
    returns the plain Cholesky value (:func:`log_marginal_likelihood`), as
    the JAX package's ``primal=`` does. ``fast_gradients`` runs the 2-pass
    legs (:func:`logml_value_and_grad`). ``x`` and ``y`` go to the card
    unless they are tensors elsewhere."""
    x, y = check_xy(x, y)
    return _scalar_vjp(
        lambda p: _logml_value_and_grad_analytic(
            p, x, y, nugget, fast_gradients=fast_gradients),
        primal=lambda p: log_marginal_likelihood(p, x, y, nugget=nugget))


def log_marginal_likelihood_hybrid_vjp(x, y, *, nugget: float = LOGML_NUGGET,
                                       probes: int = 64, probe_key=None,
                                       deflate: int | None = None):
    """A ``params -> logML`` scalar whose value and gradient come from the
    hybrid (``method="hybrid"``). The probe block is drawn once, from a
    copy of ``probe_key``'s state (``None``: a generator seeded 0 on
    ``x``'s device), so the function is a deterministic map of the
    parameters and ``probe_key`` itself is not advanced. Same gate as
    ``method="hybrid"``, checked at the call."""
    x, y = check_xy(x, y)
    gen = torch.Generator(device=x.device)
    if probe_key is None:
        gen.manual_seed(0)
    else:
        gen.set_state(probe_key.get_state())
    z = torch.randint(0, 2, (x.shape[0], probes), generator=gen,
                      device=x.device).mul_(2).sub_(1)

    def value_and_grad(p):
        full_fp32()
        _hybrid_gate(p.kernel)
        return _logml_value_and_grad_hybrid(p, x, y, nugget, z=z,
                                            deflate=deflate)

    return _scalar_vjp(value_and_grad)


class _ScalarVJP(torch.autograd.Function):
    """``value`` forward over the flat leaves; backward ``grad * ct`` from
    the gradient tree the forward computed."""

    @staticmethod
    def forward(ctx, value_and_grad, params, *flat):
        # flat are params' own leaves, passed so that autograd sees them
        value, grads = value_and_grad(params)
        ctx.grads = leaves(grads)
        return value.detach()

    @staticmethod
    def backward(ctx, ct):
        return (None, None, *(g * ct for g in ctx.grads))


def _scalar_vjp(value_and_grad_fn, *, primal=None):
    """Package ``params -> (value, grads)`` as a scalar function of a
    parameter tree whose autograd gradient is ``grads`` (first order only).
    ``primal`` (default: the value of ``value_and_grad_fn``) is what a call
    computes when no leaf needs a gradient."""

    def f(params):
        flat = leaves(params)
        if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
            return _ScalarVJP.apply(value_and_grad_fn, params, *flat)
        if primal is not None:
            return primal(params)
        return value_and_grad_fn(params)[0]

    return f


def logml_gradient_noise_floor(params: Parameters, x, y, *,
                               nugget: float = LOGML_NUGGET):
    """``(grads, floor, flagged)``: the analytic gradient, an estimate of
    the float32 noise floor of each component, and ``flagged = |grad| < 10
    floor`` where a component is in its noise (a cancelling sum whose terms
    are far larger than it, as h's at N = 16k).

    On the fused route the gradient contraction runs on both legs, 3-pass
    and 2-pass (``fast_gradients``): their difference is the 2-pass leg's
    error, and the floor is it scaled by the ratio of the legs' precisions
    (2^-21, the 3-pass products' f32 accumulation, over 2^-11, one operand
    rounded to TF32). Off it (CPU tensors, float64, small n) the floor is
    the measured ``|g - g64|`` against a float64 autograd oracle on the
    CPU, O(n^3) on the host."""
    x, y = check_xy(x, y)
    if not _fused_gate(params.kernel, x):
        return _noise_floor_x64(params, x, y, nugget)
    _, g3 = logml_value_and_grad(params, x, y, nugget=nugget)
    _, g2 = logml_value_and_grad(params, x, y, nugget=nugget,
                                 fast_gradients=True)
    ratio = 2.0 ** -21 / 2.0 ** -11
    floor = [(a.float() - b.float()).abs() * ratio
             for a, b in zip(leaves(g3), leaves(g2))]
    return g3, unflatten(g3, floor), _flagged(g3, floor)


def _flagged(grads, floor):
    return unflatten(grads, [g.float().abs() < 10.0 * f
                             for g, f in zip(leaves(grads), floor)])


def _noise_floor_x64(params: Parameters, x, y, nugget: float):
    """The off-fused leg of :func:`logml_gradient_noise_floor`: float64
    autograd through the Cholesky on the CPU as the oracle."""
    _, g = logml_value_and_grad(params, x, y, nugget=nugget)
    ps = [t.detach().cpu().double().requires_grad_() for t in leaves(params)]
    with torch.enable_grad():
        value = log_marginal_likelihood(unflatten(params, ps),
                                        x.detach().cpu().double(),
                                        y.detach().cpu().double(),
                                        nugget=nugget)
        g64 = _grads_or_zeros(value, ps)
    floor = [(a.float() - b.to(a.device).float()).abs()
             for a, b in zip(leaves(g), g64)]
    return g, unflatten(g, floor), _flagged(g, floor)


def gram_of(kernel, x, nugget):
    """The Gram the likelihood paths use (the automatic route)."""
    return kernel.gram(x, nugget=nugget)


def fit(params: Parameters, x, y, xs, *, nugget: float = PREDICT_NUGGET,
        full_cov: bool = False):
    """The GP posterior at test locations ``xs`` (GPML Algorithm 2.1,
    batched; Predict.fit): a :class:`PosteriorSummary` of marginal means
    and variances, or ``(mean, cov)`` with ``full_cov=True``.

    On the fused route (:func:`_fused_gate`, not ``full_cov``): ``K`` and
    ``K(x, xs)`` from the Gram kernel, padded as the fused logML pads
    (:func:`_pad_spd`, the residual and the cross block with zero rows);
    one ``chol_inv``; alpha through ``L^-1`` with two refinement steps (the
    mean is a cancelling sum against alpha, and one step leaves a larger
    ``K alpha - r`` residual than the triangular solves, as the JAX package
    measured); the variance from ``A = L^-1 K(x, xs)`` by one
    ``left_lower`` trmm, ``k(s, s) - |A_s|^2`` clamped at 0. Else
    ``torch.linalg``: the Cholesky factor and triangular solves, one
    solve for the whole ``(N, M)`` block. ``full_cov`` forms ``K(xs, xs) -
    A^T A`` in full float32."""
    full_fp32()
    x, y = check_xy(x, y)
    xs = as_locations(as_tensor(xs, device=x.device, dtype=x.dtype))
    kern = params.kernel
    kxx = kern.gram(x, nugget=nugget)
    kxs = kern.gram(x, xs)
    r = y - params.mean(x)
    if _fused_gate(kern, x) and not full_cov:
        alpha, a = _fused_fit_core(kxx, kxs, r)
        del kxx
        mean = params.mean(xs) + kxs.T @ alpha
    else:
        l = cholesky(kxx)
        alpha = back_solve(l.T, forward_solve(l, r))
        mean = params.mean(xs) + kxs.T @ alpha
        a = forward_solve(l, kxs)
        if full_cov:
            return mean, kern.gram(xs) - a.T @ a
    # k(s, s) - |a|^2 cancels to slightly negative in f32 where the
    # posterior variance is ~0
    var = torch.clamp_min(kern.diag(xs, dtype=mean.dtype)
                          - torch.sum(a * a, dim=0), 0.0)
    return PosteriorSummary(x=xs, mean=mean, variance=var)


def _fused_fit_core(kxx, kxs, r):
    """``(alpha, A)``: ``K^-1 r`` and ``L^-1 K(x, xs)`` on the fused route
    (:func:`fit`). On CPU tensors every kernel call takes its plain
    version."""
    n = kxx.shape[0]
    pad = (-n) % math.lcm(TILE, LEAF)
    kxx_p = _pad_spd(kxx, pad) if pad else kxx
    r_p = F.pad(r, (0, pad))
    _, l_inv = chol_inv(kxx_p)
    alpha = l_inv.T @ (l_inv @ r_p)
    for _ in range(2):
        alpha = alpha + l_inv.T @ (l_inv @ (r_p - kxx_p @ alpha))
    a = trmm(F.pad(kxs, (0, 0, 0, pad)), l_inv, mode="left_lower")
    return alpha[:n], a


def predict(summary: PosteriorSummary, interval: float = 0.95):
    """``(mean, lower, upper)`` (Predict.predict)."""
    return (summary.mean, summary.interval(1.0 - interval),
            summary.interval(interval))


def posterior_draw(key, params: Parameters, x, y, xs, *,
                   nugget: float = PREDICT_NUGGET, jitter: float = 1e-8,
                   shape=()):
    """A joint draw from the GP posterior at ``xs``, ``mean + z L^T`` with
    ``L`` the Cholesky factor of the posterior covariance plus ``jitter
    I`` and ``z`` standard normal from the generator ``key``."""
    mean, cov = fit(params, x, y, xs, nugget=nugget, full_cov=True)
    l = cholesky(add_jitter(cov, jitter))
    z = torch.randn((*shape, mean.shape[0]), generator=key, dtype=l.dtype,
                    device=l.device)
    return mean + z @ l.T


def posterior_predictive_curves(post_flat, template: Parameters, x, y, xs, *,
                                n_curves: int = 20,
                                nugget: float = PREDICT_NUGGET):
    """Posterior-predictive mean curves from MCMC hyperparameter draws
    (SimulatedGp.scala:197-247): ``post_flat`` of shape ``(chains, draws,
    dim)`` or ``(draws, dim)``, every ``draws // n_curves``-th row fitted
    in turn; returns ``(n_curves, M)`` means."""
    leaf = leaves(template)[0]
    flat = torch.as_tensor(post_flat).to(device=leaf.device, dtype=leaf.dtype)
    if flat.ndim == 3:
        flat = flat.reshape(-1, flat.shape[-1])
    take = max(1, flat.shape[0] // n_curves)
    return torch.stack([
        fit(from_array_params(template, row), x, y, xs, nugget=nugget).mean
        for row in flat[::take][:n_curves]])


def from_array_params(template: Parameters, row):
    return from_array(template, row)


def get_intervals(mean, cov, interval: float):
    """Marginal intervals of an MVN (Summarise.getIntervals)."""
    var = torch.diagonal(cov)
    return (normal_interval(mean, var, interval),
            normal_interval(mean, var, 1.0 - interval))
