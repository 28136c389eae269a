"""Mean functions as ``nn.Module``s — the port of ``gpx/means.py``.
Locations are ``(N, D)`` tensors; a mean maps them to ``(N,)``."""

from __future__ import annotations

import torch

from gpx_torch import bijectors as bij
from gpx_torch._device import as_tensor
from gpx_torch._module import FieldModule


class MeanFunction(FieldModule):
    def forward(self, x):
        raise NotImplementedError

    def bijectors(self):
        """The same mean with a bijector in every leaf slot."""
        raise NotImplementedError


class Zero(MeanFunction):
    _fields = ()

    def forward(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def bijectors(self):
        return Zero()


class Plane(MeanFunction):
    """``beta_0 + x @ beta_1:``, ``beta`` of shape ``(D + 1,)``."""

    _fields = ("beta",)

    def __init__(self, beta):
        super().__init__(beta=beta)

    def forward(self, x):
        return self.beta[0] + x @ self.beta[1:]

    def bijectors(self):
        return Plane(beta=bij.identity)


def design_matrix(x):
    """Prepend a column of ones (MeanParameters.makeDesignMatrix,
    MeanParameters.scala:58-66): ``(N, D)`` -> ``(N, D + 1)``."""
    ones = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    return torch.cat([ones, x], dim=-1)


def plane(beta, *, device=None, dtype=None) -> Plane:
    return Plane(beta=as_tensor(beta, device=device, dtype=dtype))


def zero() -> Zero:
    return Zero()
