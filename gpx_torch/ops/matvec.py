"""Matrix-free Gram products — the port of the public functions of
``gpx/ops/pallas_matvec.py``.

``gram_matvec`` and ``cross_matvec`` compute ``K V`` without forming K, so
the iterative path (:mod:`gpx_torch.models.gp_iterative`) needs O(N (D + R))
memory. A float32 CUDA tensor with a stationary, Pallas-safe kernel goes to
the CUDA kernel (:mod:`gpx_torch.ops.cuda_matvec`), at any N and any number
of columns, and raises where the CUDA term table does not hold the kernel
(``NotImplementedError`` for a part with no device function,
``ValueError`` for a tree that expands past
:data:`~gpx_torch.kernels.MAX_TERMS` factors). CPU tensors, float64, and
kernels that are not stationary or not Pallas-safe (which the JAX package
sends to XLA too) take the plain row-blocked torch route. A build or launch
error raises.
"""

from __future__ import annotations

import torch

from gpx_torch.kernels import check_table, unwrap_ard
from gpx_torch.ops.cuda_matvec import (
    _cross_matvec_torch, _gram_matvec_torch, cross_matvec_cuda,
    gram_matvec_cuda,
)
from gpx_torch.ops.distance import as_locations


def _uses_cuda_kernel(kernel, x) -> bool:
    """Whether the product goes to the CUDA kernel: the JAX package's gate
    (stationary and Pallas-safe) for a float32 CUDA tensor. Such a kernel
    that the term table lacks raises rather than run the O(N^2) plain
    route at every solver step."""
    if not (x.device.type == "cuda" and x.dtype == torch.float32
            and kernel.is_stationary and kernel.pallas_safe):
        return False
    if not kernel.cuda_supported:
        raise NotImplementedError(
            f"the matvec on the card needs the CUDA term table to hold this "
            f"{type(kernel).__name__}: a part of it has no CUDA device "
            f"function")
    check_table(kernel)
    return True


def _as_columns(v):
    return (v[:, None], True) if v.ndim == 1 else (v, False)


def gram_matvec(kernel, x, v, *, nugget: float = 0.0):
    """``(K(x, x) + nugget I) @ v`` with K streamed, never stored. ``v``:
    (N,) or (N, R)."""
    x = as_locations(x)
    kernel, x, _ = unwrap_ard(kernel, x)
    # distances are translation-invariant; centring keeps coordinate
    # rounding out of the float32 r2
    x = x - x.mean(dim=0, keepdim=True).detach()
    v2, squeeze = _as_columns(v)
    if _uses_cuda_kernel(kernel, x):
        out = gram_matvec_cuda(kernel, x, v2.to(torch.float32),
                               nugget=nugget).to(v2.dtype)
    else:
        out = _gram_matvec_torch(kernel, x, v2, nugget)
    return out[:, 0] if squeeze else out


def cross_matvec(kernel, x1, x2, v):
    """``K(x1, x2) @ v`` streamed the same way: no nugget and no forced
    diagonal; duplicates across the two sets still get White's term.
    ``v``: (N2,) or (N2, R)."""
    x1, x2 = as_locations(x1), as_locations(x2)
    kernel, x1, x2 = unwrap_ard(kernel, x1, x2)
    center = x2.mean(dim=0, keepdim=True).detach()
    x1, x2 = x1 - center, x2 - center
    v2, squeeze = _as_columns(v)
    if _uses_cuda_kernel(kernel, x1):
        out = cross_matvec_cuda(kernel, x1, x2, v2.to(torch.float32)).to(v2.dtype)
    else:
        out = _cross_matvec_torch(kernel, x1, x2, v2)
    return out[:, 0] if squeeze else out
