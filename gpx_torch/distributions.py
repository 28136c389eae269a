"""Probability distributions: log-densities and samplers — the port of
``gpx/distributions.py`` (the reference's Breeze distributions and its
``GradDist`` wrapper, GradDist.scala:5-24; here ``grad_logpdf`` is
autograd of the log-density).

``sample`` takes an explicit ``torch.Generator`` on the device the draws
go to (the parameters' device). Torch's generators do not give the JAX
package's numbers: compare the two by distribution, or feed both the
same noise.

``Gamma(concentration, rate)`` has mean ``concentration / rate``;
``InverseGamma(concentration, scale)`` mean ``scale / (concentration -
1)``.
"""

from __future__ import annotations

import math

import torch

from gpx_torch._device import as_tensor
from gpx_torch._module import FieldModule


def grad_logpdf(dist, x):
    """``d log p(x) / dx`` by autograd (GradDist.scala:5-24)."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        (g,) = torch.autograd.grad(torch.sum(dist.logpdf(x)), x)
    return g


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


class Normal(FieldModule):
    _fields = ("loc", "scale")

    def __init__(self, loc, scale):
        super().__init__(loc=as_tensor(loc), scale=as_tensor(scale))

    def logpdf(self, x):
        s2 = self.scale * self.scale
        return (torch.log(2.0 * math.pi * s2) + (x - self.loc) ** 2 / s2) / -2.0

    def sample(self, generator, shape=()):
        z = torch.randn(_shape(shape), generator=generator,
                        dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self.scale * z

    def ppf(self, q):
        """Inverse CDF (Summarise.getInterval, Summarise.scala:10-12)."""
        return self.loc + self.scale * torch.special.ndtri(
            torch.as_tensor(q, dtype=self.loc.dtype, device=self.loc.device))


def _standard_gamma(concentration, shape, generator):
    a = concentration.expand(_shape(shape)).contiguous()
    return torch._standard_gamma(a, generator=generator)


class Gamma(FieldModule):
    """Gamma with shape ``concentration`` and ``rate``."""

    _fields = ("concentration", "rate")

    def __init__(self, concentration, rate):
        super().__init__(concentration=as_tensor(concentration),
                         rate=as_tensor(rate))

    def logpdf(self, x):
        x = torch.as_tensor(x, dtype=self.rate.dtype, device=self.rate.device)
        ok = x >= 0
        scale = 1.0 / self.rate
        y = torch.where(ok, x / scale, torch.ones_like(x))
        log_probs = (torch.special.xlogy(self.concentration - 1.0, y) - y
                     - (torch.lgamma(self.concentration) + torch.log(scale)))
        return torch.where(ok, log_probs, float("-inf"))

    def sample(self, generator, shape=()):
        return _standard_gamma(self.concentration, shape, generator) / self.rate


class InverseGamma(FieldModule):
    """InverseGamma(concentration a, scale b)."""

    _fields = ("concentration", "scale")

    def __init__(self, concentration, scale):
        super().__init__(concentration=as_tensor(concentration),
                         scale=as_tensor(scale))

    def logpdf(self, x):
        a, b = self.concentration, self.scale
        return (a * torch.log(b) - torch.lgamma(a) - (a + 1.0) * torch.log(x)
                - b / x)

    def sample(self, generator, shape=()):
        return self.scale / _standard_gamma(self.concentration, shape,
                                            generator)


class Uniform(FieldModule):
    _fields = ("low", "high")

    def __init__(self, low, high):
        super().__init__(low=as_tensor(low), high=as_tensor(high))

    def logpdf(self, x):
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, -torch.log(self.high - self.low),
                           float("-inf"))

    def sample(self, generator, shape=()):
        u = torch.rand(_shape(shape), generator=generator,
                       dtype=self.low.dtype, device=self.low.device)
        return self.low + (self.high - self.low) * u


class MultivariateNormal(FieldModule):
    """MVN by its mean and the lower Cholesky factor of its covariance."""

    _fields = ("mean", "chol")

    def __init__(self, mean, chol):
        super().__init__(mean=as_tensor(mean), chol=as_tensor(chol))

    @staticmethod
    def from_cov(mean, cov, jitter: float = 0.0):
        cov = as_tensor(cov)
        if jitter:
            cov = cov + jitter * torch.eye(cov.shape[-1], dtype=cov.dtype,
                                           device=cov.device)
        return MultivariateNormal(mean=mean, chol=torch.linalg.cholesky(cov))

    def logpdf(self, x):
        d = x - self.mean
        u = torch.linalg.solve_triangular(self.chol, d[:, None],
                                          upper=False)[:, 0]
        n = self.mean.shape[-1]
        half_logdet = torch.sum(torch.log(torch.diagonal(self.chol)))
        return -0.5 * (u @ u) - half_logdet - 0.5 * n * math.log(2.0 * math.pi)

    def sample(self, generator, shape=()):
        n = self.mean.shape[-1]
        z = torch.randn((*_shape(shape), n), generator=generator,
                        dtype=self.chol.dtype, device=self.chol.device)
        return self.mean + z @ self.chol.T


class StudentT(FieldModule):
    """Location-scale Student-t (the conjugate DLM filter's forecast)."""

    _fields = ("df", "loc", "scale")

    def __init__(self, df, loc, scale):
        super().__init__(df=as_tensor(df), loc=as_tensor(loc),
                         scale=as_tensor(scale))

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        half_df = self.df / 2.0
        norm = (torch.lgamma(half_df)
                + torch.log(self.scale * self.scale * math.pi * self.df) / 2.0
                - torch.lgamma(half_df + 0.5))
        return -(norm + (half_df + 0.5) * torch.log1p(z * z / self.df))

    def sample(self, generator, shape=()):
        z = torch.randn(_shape(shape), generator=generator,
                        dtype=self.loc.dtype, device=self.loc.device)
        chi2 = 2.0 * _standard_gamma(self.df / 2.0, shape, generator)
        return self.loc + self.scale * z * torch.rsqrt(chi2 / self.df)

    def cdf(self, x):
        """``F(t) = 1 - I_{df/(df+t^2)}(df/2, 1/2) / 2`` for ``t >= 0``, by
        the regularized incomplete beta (:func:`betainc`)."""
        z = (torch.as_tensor(x, dtype=self.loc.dtype, device=self.loc.device)
             - self.loc) / self.scale
        w = betainc(0.5 * self.df, torch.full_like(self.df, 0.5),
                    self.df / (self.df + z * z))
        return torch.where(z >= 0, 1.0 - 0.5 * w, 0.5 * w)

    def ppf(self, q):
        """Inverse CDF by 90 bisections of the standardized bracket [-1e8,
        1e8] on :meth:`cdf`, as the JAX package (it has no incomplete-beta
        inverse either): f64 precision for ``df >= 0.5`` and ``q`` in
        (1e-9, 1 - 1e-9)."""
        q = torch.as_tensor(q, dtype=self.loc.dtype, device=self.loc.device)
        std = StudentT(df=self.df, loc=torch.zeros_like(self.loc),
                       scale=torch.ones_like(self.scale))
        shape = torch.broadcast_shapes(q.shape, self.df.shape, self.loc.shape,
                                       self.scale.shape)
        lo = torch.full(shape, -1e8, dtype=q.dtype, device=q.device)
        hi = -lo
        for _ in range(90):
            mid = 0.5 * (lo + hi)
            below = std.cdf(mid) < q
            lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
        return self.loc + self.scale * 0.5 * (lo + hi)


# Lentz steps of the continued fraction: against scipy, 1e-15 absolute for
# a <= 50, 7e-14 at a = 500 and 5e-12 at a = 5000 (Student-t df = 2a)
_BETACF_STEPS = 48


def _betacf(a, b, x):
    """The continued fraction of ``I_x(a, b)`` (Numerical Recipes §6.4,
    modified Lentz), a fixed number of steps; it converges fast for ``x <
    (a + 1) / (a + b + 2)``."""
    tiny = 1e-300 if x.dtype == torch.float64 else 1e-30

    def guard(v):
        return torch.where(torch.abs(v) < tiny, tiny, v)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / guard(1.0 - qab * x / qap)
    h = d
    for m in range(1, _BETACF_STEPS + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        h = h * d * c
    return h


def betainc(a, b, x):
    """The regularized incomplete beta ``I_x(a, b)`` for ``a, b > 0`` and
    ``0 <= x <= 1``, in plain torch (torch has none): the continued
    fraction where it converges fast, through the symmetry ``I_x(a, b) = 1
    - I_{1-x}(b, a)`` elsewhere (the arguments swapped per element before
    the one fraction runs), on inputs held inside (0, 1); the ends are
    exactly 0 and 1."""
    a, b, x = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b),
                                      torch.as_tensor(x))
    inner = (x > 0) & (x < 1)
    xs = torch.where(inner, x, 0.5)
    front = torch.exp(torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
                      + a * torch.log(xs) + b * torch.log1p(-xs))
    swap = xs >= (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    part = front * _betacf(aa, bb, torch.where(swap, 1.0 - xs, xs)) / aa
    val = torch.where(swap, 1.0 - part, part)
    return torch.where(inner, val, torch.where(x <= 0, 0.0, 1.0))


def student_t_interval(mean, scale, df, q):
    """Student-t inverse-CDF interval of the conjugate filter's forecasts,
    the t analog of :func:`normal_interval`. A ``mean`` that is not a
    tensor goes to the card."""
    mean = as_tensor(mean)
    if not mean.is_floating_point():
        mean = mean.to(torch.get_default_dtype())
    scale, df = (torch.as_tensor(v, dtype=mean.dtype, device=mean.device)
                 for v in (scale, df))
    return StudentT(df=df, loc=mean, scale=scale).ppf(q)


def normal_interval(mean, variance, q):
    """Gaussian inverse-CDF interval (Summarise.getInterval,
    Summarise.scala:10-12)."""
    mean = torch.as_tensor(mean)
    return mean + torch.sqrt(torch.as_tensor(variance)) * torch.special.ndtri(
        torch.as_tensor(q, dtype=mean.dtype, device=mean.device))
