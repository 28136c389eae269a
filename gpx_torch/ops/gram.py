"""Gram (covariance) matrix construction — the port of ``gpx/ops/gram.py``.

``method="auto"`` sends a float32 CUDA tensor with a kernel the CUDA device
functions support to the CUDA Gram kernel (:mod:`gpx_torch.ops.cuda_gram`);
everything else takes the plain torch route. (The JAX package's area
threshold for its TPU kernel was measured on the TPU and is not carried
over.) ``"xla"`` asks for the plain route and ``"pallas"`` for the kernel,
which takes its plain version on CPU tensors as the JAX package's
interpret mode does.
"""

from __future__ import annotations

import torch

from gpx_torch.kernels import check_table, unwrap_ard
from gpx_torch.ops.cuda_gram import gram_cuda, gram_reference
from gpx_torch.ops.distance import as_locations


def gram(kernel, x, x2=None, *, nugget: float = 0.0, method: str = "auto",
         center_of=None):
    """Covariance matrix ``K[i, j] = k(x[i], x2[j])``; symmetric
    (``x2 is None``) adds ``nugget * I``. The coordinates are centred on
    the mean of ``x``, or of ``center_of``: a block of the Gram of a larger
    set, centred on that set, holds that Gram's entries, with White where
    its r2 is exactly 0."""
    x = as_locations(x)
    if x2 is not None:
        x2 = as_locations(x2)
    center = None
    if center_of is not None:
        center = unwrap_ard(kernel, as_locations(center_of))[1].mean(
            dim=0, keepdim=True).detach()
    kernel, x, x2 = unwrap_ard(kernel, x, x2)
    if method == "auto":
        method = "pallas" if uses_cuda_kernel(kernel, x) else "xla"
    if method == "pallas":
        if not kernel.is_stationary:
            raise ValueError("the Gram kernel requires a stationary kernel")
        if not kernel.pallas_safe:
            raise ValueError("kernel is not pallas-safe (e.g. general-nu "
                             "Matern); use method='xla'")
        return gram_cuda(kernel, x, x2, nugget=nugget, center=center)
    if method != "xla":
        raise ValueError(f"unknown gram method: {method}")
    return gram_reference(kernel, x, x2, nugget, center)


def uses_cuda_kernel(kernel, x) -> bool:
    """Whether :func:`gram` sends this kernel and input to the CUDA kernel;
    raises ``ValueError`` for a tree that it would send there whose
    expansion the term table cannot take (:func:`~gpx_torch.kernels.
    check_table`), before anything launches."""
    on_card = (x.device.type == "cuda" and x.dtype == torch.float32
               and kernel.is_stationary and kernel.cuda_supported)
    if on_card:
        check_table(kernel)
    return on_card


def cross_gram(kernel, x1, x2, *, method: str = "auto"):
    """Cross-covariance ``K(x1, x2)`` (KernelFunction.buildDistCov, with
    the reference's row-0 / column-0 fault fixed)."""
    return gram(kernel, x1, as_locations(x2), method=method)


def tangent_grams(kernel, x, *, method: str = "auto"):
    """``dK/d theta`` per hyperparameter leaf, a kernel-shaped tree of
    ``(N, N)`` matrices: the forward-mode derivative of the Gram along each
    leaf with an all-ones tangent (an ``Ard``'s ``ell`` moves all its
    entries at once), as the JAX package seeds it. Each is formed as the
    reverse-mode derivative of a reverse-mode product, ``J u = d/dv (u .
    J^T v)``: two backward passes a leaf. The derivative is the plain
    expression's on every ``method``: the CUDA Gram's derivative is defined
    as that expression's, as its backward is."""
    from gpx_torch.params import leaves, unflatten

    if method not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown gram method: {method}")
    x = as_locations(x)
    with torch.enable_grad():
        ls = [t.detach().requires_grad_() for t in leaves(kernel)]
        k = gram(unflatten(kernel, ls), x, method="xla")
        v = torch.zeros_like(k, requires_grad=True)
        jtv = torch.autograd.grad(k, ls, v, create_graph=True)
        tangents = [torch.autograd.grad(g, v, torch.ones_like(t),
                                        retain_graph=True)[0].detach()
                    for t, g in zip(ls, jtv)]
    return unflatten(kernel, tangents)


def build_cov_matrix(kxx, kyy, kxy):
    """``[[kxx, kxy], [kxy^T, kyy]]`` (KernelFunction.buildCovMatrix)."""
    return torch.cat([torch.cat([kxx, kxy], dim=1),
                      torch.cat([kxy.T, kyy], dim=1)], dim=0)
