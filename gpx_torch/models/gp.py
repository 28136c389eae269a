"""Gaussian-process marginal likelihood and its gradient — the port of the
main path of ``gpx/models/gp.py``.

``logml_value_and_grad(params, x, y)`` with ``method="analytic"`` is the
path every user of the library reaches (samplers call it once per leapfrog
step, type-II MLE once per step). On the card, in float32, for a kernel the
CUDA device functions support and ``n >= FUSED_MIN_N``, it runs the fused
route: the Gram kernel, ``chol_inv`` over the leaf and product kernels, and
the fused gradient kernel. Everything else takes the non-fused route on
``torch.linalg``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpx_torch._device import full_fp32
from gpx_torch.ops.chol import (
    back_solve, cholesky, forward_solve, spd_inverse_from_chol,
)
from gpx_torch.ops.cuda_chol import LEAF, chol_inv
from gpx_torch.ops.cuda_logml_grad import TILE, logml_kernel_grads
from gpx_torch.ops.distance import check_xy
from gpx_torch.ops.gram import gram, uses_cuda_kernel
from gpx_torch.params import Parameters, leaves, unflatten

LOGML_NUGGET = 1e-3  # the reference's Tikhonov nugget (GaussianProcess.scala:117)

# Smallest n that takes the fused route: chip_smoke.py times both routes
# at n = 1024 ... 16384 on the card. On an H100 (700 W) the fused route
# lost at 2048 and 4096 and won at 8192 and 16384 (PERF.md).
FUSED_MIN_N = 8192

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def log_marginal_likelihood(params: Parameters, x, y, *,
                            nugget: float = LOGML_NUGGET):
    """Exact GP marginal log-likelihood: Gram + nugget, one Cholesky, one
    forward solve."""
    full_fp32()
    x, y = check_xy(x, y)
    n = x.shape[0]
    l = cholesky(gram(params.kernel, x, nugget=nugget))
    u = forward_solve(l, y - params.mean(x))
    half_logdet = torch.sum(torch.log(torch.diagonal(l)))
    return -0.5 * (u @ u) - half_logdet - n * _HALF_LOG_2PI


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
                         fast_gradients: bool = False):
    """``(logML, d logML / d params)``, the gradient as a ``Parameters``
    tree of the same structure.

    ``method="analytic"`` uses the trace identity ``d logML/d theta =
    0.5 (alpha^T G alpha - tr(K^-1 G))``, ``G = dK/d theta`` (fused route
    on the card, see :func:`_fused_gate`); ``method="autodiff"`` runs
    torch autograd through ``torch.linalg.cholesky``. The hybrid method and
    ``fast_gradients`` are not ported yet."""
    if fast_gradients:
        raise NotImplementedError("fast_gradients is not ported yet")
    if method == "hybrid":
        raise NotImplementedError("method='hybrid' is not ported yet")
    full_fp32()
    if method == "autodiff":
        ps = [t.detach().requires_grad_() for t in leaves(params)]
        with torch.enable_grad():
            value = log_marginal_likelihood(unflatten(params, ps), x, y,
                                            nugget=nugget)
            grads = _grads_or_zeros(value, ps)
        return value.detach(), unflatten(params, grads)
    if method != "analytic":
        raise ValueError(f"unknown method: {method}")
    return _logml_value_and_grad_analytic(params, x, y, nugget)


def _fused_gate(kernel, x) -> bool:
    """Whether the fused route applies: float32 on the card, ``n >=
    FUSED_MIN_N``, and a kernel the CUDA device functions support. Any
    such ``n`` qualifies; :func:`_fused_logml_core` pads it."""
    return uses_cuda_kernel(kernel, x) and x.shape[0] >= FUSED_MIN_N


def _pad_spd(k, pad: int):
    """Embed ``K`` in ``blockdiag(K, I_pad)``: its factor is
    ``blockdiag(L, I)`` and its inverse ``blockdiag(L^-1, I)``, exactly."""
    n = k.shape[-1]
    kp = F.pad(k, (0, pad, 0, pad))
    kp[n:, n:].fill_diagonal_(1.0)
    return kp


def _fused_logml_core(kernel, x, r, k_val, nugget: float, *,
                      base: int = LEAF):
    """The fused leg at any ``n``: returns ``(value, d_kernel, alpha)``.

    ``n`` is padded to a multiple of the port's tiles (the gradient kernel's
    64 and the leaf size ``base``) with :func:`_pad_spd`; the residual pads
    with zeros and the coordinates with copies of ``x[0]``. The gradient
    contraction gets ``l_inv`` with its pad rows zeroed, so every pad entry
    meets an exactly-zero weight, and the logdet correction uses the real
    ``n``. On CPU tensors every kernel call takes its plain version."""
    n = x.shape[0]
    pad = (-n) % math.lcm(TILE, base)
    if pad:
        k_mat = _pad_spd(k_val, pad)
        r_vec = F.pad(r, (0, pad))
        x_c = torch.cat([x, x[:1].expand(pad, x.shape[1])])
    else:
        k_mat, r_vec, x_c = k_val, r, x

    l, l_inv = chol_inv(k_mat, base=base)
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
    d_kernel, (tkw, trw) = logml_kernel_grads(kernel, x_c, alpha, l_inv)

    # first-order logdet correction with W_hat = l_inv^T l_inv:
    # logdet K = -2 sum log diag(l_inv) + (tr(W_hat K) - n) + O(||E||^2)
    half_logdet = -log_diag + 0.5 * (tkw + nugget * trw - n)
    value = -0.5 * quad - half_logdet - n * _HALF_LOG_2PI
    return value, d_kernel, alpha[:n]


def _logml_value_and_grad_analytic(params: Parameters, x, y, nugget: float):
    x, y = check_xy(x, y)
    n = x.shape[0]
    ms = [t.detach().requires_grad_() for t in leaves(params.mean)]
    with torch.enable_grad():
        mean_val = unflatten(params.mean, ms)(x)
    r = y - mean_val.detach()

    if _fused_gate(params.kernel, x):
        k_val = gram(params.kernel, x, nugget=nugget)
        value, d_kernel, alpha = _fused_logml_core(
            params.kernel, x, r, k_val, nugget)
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
