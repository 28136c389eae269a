"""Gram (covariance) matrix construction — the port of ``gpx/ops/gram.py``.

A float32 CUDA tensor with a kernel the CUDA device functions support goes
to the CUDA Gram kernel (:mod:`gpx_torch.ops.cuda_gram`); everything else
takes the plain torch route. (The JAX package's area threshold for its
TPU kernel was measured on the TPU and is not carried over.)
"""

from __future__ import annotations

import torch

from gpx_torch.kernels import unwrap_ard
from gpx_torch.ops.cuda_gram import gram_cuda, gram_reference
from gpx_torch.ops.distance import as_locations


def gram(kernel, x, x2=None, *, nugget: float = 0.0):
    """Covariance matrix ``K[i, j] = k(x[i], x2[j])``; symmetric
    (``x2 is None``) adds ``nugget * I``."""
    x = as_locations(x)
    if x2 is not None:
        x2 = as_locations(x2)
    kernel, x, x2 = unwrap_ard(kernel, x, x2)
    if uses_cuda_kernel(kernel, x):
        return gram_cuda(kernel, x, x2, nugget=nugget)
    return gram_reference(kernel, x, x2, nugget)


def uses_cuda_kernel(kernel, x) -> bool:
    """Whether :func:`gram` sends this kernel and input to the CUDA kernel."""
    return (x.device.type == "cuda" and x.dtype == torch.float32
            and kernel.is_stationary and kernel.cuda_supported)
