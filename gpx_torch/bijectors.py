"""Bijectors from the sampler's unconstrained space to the parameters'
constrained one — the port of ``gpx/bijectors.py`` (the reference's
``unbounded`` / ``bounded`` / ``boundedBelow`` / ``boundedAbove`` and its
``logistic`` / ``logit`` / ``softplus`` helpers, KernelParameters.scala:
323-370). Gradients of the change-of-variables term come from autograd of
``log_det_jacobian``.

Bijectors are static objects, not tensors: a kernel, mean or
``Parameters`` built with a bijector in each leaf slot (``bijectors()``)
is walked by :func:`gpx_torch.params.leaves` like the parameter tree it
mirrors.
"""

from __future__ import annotations

import math

import torch


def _softplus(x):
    """``log(1 + exp(x))`` in the JAX package's form (``logaddexp(x, 0)``),
    with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


class Bijector:
    """Monotone map ``forward: R -> constrained domain``."""

    def forward(self, u):
        raise NotImplementedError

    def inverse(self, c):
        raise NotImplementedError

    def log_det_jacobian(self, u):
        """``log |d forward(u) / du|`` elementwise at ``u``."""
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.__dict__.items()))))


class Identity(Bijector):
    """The reference's ``unbounded`` (KernelParameters.scala:344-345)."""

    def forward(self, u):
        return u

    def inverse(self, c):
        return c

    def log_det_jacobian(self, u):
        return torch.zeros_like(u)


class BoundedBelow(Bijector):
    """``c = exp(u) + min`` (KernelParameters.scala:356-362); ``min = 0``
    is the log/exp transform of ``unconstrainParams`` / ``constrainParams``
    (KernelParameters.scala:251-264)."""

    def __init__(self, minimum: float = 0.0):
        self.minimum = float(minimum)

    def forward(self, u):
        return torch.exp(u) + self.minimum

    def inverse(self, c):
        return torch.log(c - self.minimum)

    def log_det_jacobian(self, u):
        return u


class BoundedAbove(Bijector):
    """``c = max - exp(-u)`` (KernelParameters.scala:364-370)."""

    def __init__(self, maximum: float = 0.0):
        self.maximum = float(maximum)

    def forward(self, u):
        return self.maximum - torch.exp(-u)

    def inverse(self, c):
        return -torch.log(self.maximum - c)

    def log_det_jacobian(self, u):
        return -u


class Bounded(Bijector):
    """``c = logistic(u) * (max - min) + min``
    (KernelParameters.scala:347-354)."""

    def __init__(self, minimum: float, maximum: float):
        self.minimum = float(minimum)
        self.maximum = float(maximum)

    def forward(self, u):
        return torch.sigmoid(u) * (self.maximum - self.minimum) + self.minimum

    def inverse(self, c):
        p = (c - self.minimum) / (self.maximum - self.minimum)
        return torch.log(p) - torch.log1p(-p)

    def log_det_jacobian(self, u):
        # log((max - min) sigmoid(u) sigmoid(-u)) in a stable form
        return (math.log(self.maximum - self.minimum) - _softplus(-u)
                - _softplus(u))


class Softplus(Bijector):
    """``c = log1p(exp(u))``: the reference's ``softplus``
    (KernelParameters.scala:329-330) as a bijector for positive
    parameters."""

    def forward(self, u):
        return _softplus(u)

    def inverse(self, c):
        return c + torch.log(-torch.expm1(-c))

    def log_det_jacobian(self, u):
        return -_softplus(-u)


def logistic(x):
    """KernelParameters.scala:323-324."""
    return torch.sigmoid(x)


def logit(p):
    """KernelParameters.scala:326-327."""
    return torch.log(p) - torch.log1p(-p)


def softplus(x):
    """KernelParameters.scala:329-330."""
    return _softplus(x)


identity = Identity()
positive = BoundedBelow(0.0)
