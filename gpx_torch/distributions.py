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


def normal_interval(mean, variance, q):
    """Gaussian inverse-CDF interval (Summarise.getInterval,
    Summarise.scala:10-12)."""
    mean = torch.as_tensor(mean)
    return mean + torch.sqrt(torch.as_tensor(variance)) * torch.special.ndtri(
        torch.as_tensor(q, dtype=mean.dtype, device=mean.device))
