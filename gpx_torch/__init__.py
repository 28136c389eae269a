"""gpx_torch — the port of ``gpx`` to PyTorch and CUDA on an NVIDIA H100.

The same module layout and public names as ``gpx``. Kernels, means and
``Parameters`` are ``nn.Module``s holding their hyperparameters as tensors;
everything else is plain functions on tensors. Entry points run on the CUDA
card unless the caller passes CPU tensors or ``device="cpu"``.
"""

from gpx_torch import bijectors, distributions, kernels, means, params
from gpx_torch.kernels import (
    Ard,
    Linear,
    Matern,
    Periodic,
    Product,
    RationalQuadratic,
    SquaredExponential,
    Sum,
    White,
    ard,
    linear,
    matern,
    periodic,
    rational_quadratic,
    se,
    white,
)
from gpx_torch.means import Plane, Zero, plane, zero
from gpx_torch.params import Parameters

__all__ = [
    "bijectors",
    "distributions",
    "kernels",
    "means",
    "params",
    "Ard",
    "Linear",
    "Matern",
    "Periodic",
    "Product",
    "RationalQuadratic",
    "SquaredExponential",
    "Sum",
    "White",
    "ard",
    "linear",
    "matern",
    "periodic",
    "rational_quadratic",
    "se",
    "white",
    "Plane",
    "Zero",
    "plane",
    "zero",
    "Parameters",
]
