"""Modified Bessel function of the second kind ``K_nu`` for real order —
the port of ``gpx/ops/besselk.py``, plain torch (general-``nu`` Matérn is
kept off the CUDA kernels, as the JAX package keeps it off Pallas).

The two regimes of the JAX package, for a static Python ``nu``:

* ``x <= 2``: Temme's series for ``K_mu`` and ``K_{mu+1}`` with ``|mu| <=
  1/2`` (Temme 1975, J. Comp. Phys. 19; Numerical Recipes §6.7's
  ``bessik``), a fixed number of terms;
* ``x > 2``: the Steed / Thompson-Barnett continued fraction CF2 for the
  same two orders, a fixed number of steps;
* the upward recurrence ``K_{v+1} = K_{v-1} + (2v/x) K_v`` lifts ``mu`` to
  ``nu``.

Both regimes run on inputs clamped into their own domain and are joined
by ``torch.where`` (the double-``where`` trick), so the unused branch can
put a NaN neither in the value nor in a gradient. The x-derivative is the
recurrence ``d K_nu / dx = -(K_{nu-1} + K_{nu+1}) / 2`` (a
``torch.autograd.Function``, as the JAX package's ``custom_jvp``), not
autograd through the loops.
"""

from __future__ import annotations

import math

import torch

_EULER_GAMMA = 0.5772156649015328606


def _n_iters(dtype):
    """``(series, CF2)`` step counts. The CF2 auxiliaries grow
    factorially while their products converge: in float32, running past
    convergence overflows ``c`` against an underflowed ``qnew`` (inf * 0 =
    NaN), so float32 stops at 25 steps."""
    if torch.finfo(dtype).bits <= 32:
        return 25, 25
    return 40, 60


def _temme_series(x, xmu: float):
    """``(K_mu(x), K_{mu+1}(x))`` for ``0 < x <= 2``, ``|xmu| <= 1/2``."""
    gampl = 1.0 / math.gamma(1.0 + xmu)
    gammi = 1.0 / math.gamma(1.0 - xmu)
    gam1 = -_EULER_GAMMA if abs(xmu) < 1e-10 else (gammi - gampl) / (2.0 * xmu)
    gam2 = (gammi + gampl) / 2.0

    x2 = 0.5 * x
    pimu = math.pi * xmu
    fact = 1.0 if abs(pimu) < 1e-10 else pimu / math.sin(pimu)
    d = -torch.log(x2)
    e = xmu * d
    tiny_e = torch.abs(e) < 1e-12
    # sinh(e) / e with its e -> 0 limit
    fact2 = torch.where(tiny_e, 1.0,
                        torch.sinh(e) / torch.where(tiny_e, 1.0, e))
    ff = fact * (gam1 * torch.cosh(e) + gam2 * fact2 * d)
    ee = torch.exp(e)
    p = 0.5 * ee / gampl          # (x/2)^-mu Gamma(1 + mu) / 2
    q = 0.5 / (ee * gammi)        # (x/2)^+mu Gamma(1 - mu) / 2
    c = torch.ones_like(x)
    dd = x2 * x2
    ksum, ksum1 = ff, p
    for i in range(1, _n_iters(x.dtype)[0] + 1):
        ff = (i * ff + p + q) / (i * i - xmu * xmu)
        c = c * dd / i
        p = p / (i - xmu)
        q = q / (i + xmu)
        ksum = ksum + c * ff
        ksum1 = ksum1 + c * (p - i * ff)
    return ksum, ksum1 * (2.0 / x)


def _cf2(x, xmu: float):
    """``(K_mu(x), K_{mu+1}(x))`` for ``x > 2`` by the continued
    fraction."""
    a1 = 0.25 - xmu * xmu
    b = 2.0 * (1.0 + x)
    d = 1.0 / b
    h = d
    delh = d
    q1 = torch.zeros_like(x)
    q2 = torch.ones_like(x)
    q = torch.full_like(x, a1)
    c = torch.full_like(x, a1)
    a = torch.full_like(x, -a1)
    s = 1.0 + q * h
    for i in range(2, _n_iters(x.dtype)[1] + 2):
        a = a - 2.0 * (i - 1.0)
        c = -a * c / i
        qnew = (q1 - b * q2) / a
        q1, q2 = q2, qnew
        q = q + c * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        h = h + delh
        s = s + q * delh
    h = a1 * h
    rkmu = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-x) / s
    rk1 = rkmu * (xmu + x + 0.5 - h) / x
    return rkmu, rk1


def _kv(nu: float, x):
    nu = abs(float(nu))
    nl = int(nu + 0.5)
    xmu = nu - nl                      # in [-1/2, 1/2]
    small = x <= 2.0
    x_s = torch.clamp(x, torch.finfo(x.dtype).tiny, 2.0)
    x_l = torch.clamp_min(x, 2.0)
    k_s, k1_s = _temme_series(x_s, xmu)
    k_l, k1_l = _cf2(x_l, xmu)
    rkmu = torch.where(small, k_s, k_l)
    rk1 = torch.where(small, k1_s, k1_l)
    xi2 = 2.0 / x
    for i in range(1, nl + 1):
        rkmu, rk1 = rk1, (xmu + i) * xi2 * rk1 + rkmu
    return rkmu


class _Kv(torch.autograd.Function):
    """``K_nu(x)`` with the recurrence as its x-derivative; the backward
    calls this function again, so it differentiates once more too."""

    @staticmethod
    def forward(ctx, x, nu):
        ctx.nu = nu
        ctx.save_for_backward(x)
        return _kv(nu, x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        dkdx = -0.5 * (_Kv.apply(x, ctx.nu - 1.0) + _Kv.apply(x, ctx.nu + 1.0))
        return grad * dkdx, None


def kv(nu: float, x):
    """``K_nu(x)`` for a static real ``nu`` (any sign: ``K_-nu = K_nu``) and
    a tensor ``x > 0``."""
    return _Kv.apply(torch.as_tensor(x), float(nu))
