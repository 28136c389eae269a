"""The Gram kernel (``csrc/gram.cu``) and its plain version.

Port of ``gpx/ops/pallas_gram.py::pallas_gram``. The wrapper takes the
plain version only for CPU tensors; for CUDA tensors it launches the kernel
or raises. As in the JAX package, the gradient (``torch.autograd``) is the
VJP of the plain expression.
"""

from __future__ import annotations

import torch

from gpx_torch.kernels import has_white
from gpx_torch.ops import _build
from gpx_torch.ops.distance import as_locations, sq_distances
from gpx_torch.ops.terms import COLS, table_tensors
from gpx_torch.params import leaves, unflatten

_ARGS = [_build.P, _build.P, _build.I, _build.I, _build.I, _build.P,
         _build.I, _build.P, _build.I, _build.F, _build.I, _build.P,
         _build.L, _build.P]


def gram_reference(kernel, x, x2=None, nugget: float = 0.0, center=None):
    """``k(r2(x, x2))`` (+ ``nugget * I`` when symmetric) in plain torch:
    the kernel's arithmetic, at any type and for any kernel. ``center``:
    the ``(1, D)`` row the coordinates are centred on (default: ``x``'s
    mean)."""
    x = as_locations(x)
    r2 = sq_distances(x, x2, exact=x.shape[-1] > 8 and has_white(kernel),
                      center=center)
    k = kernel.evaluate_xx(x, x if x2 is None else as_locations(x2), r2)
    if x2 is None and nugget:
        k = k + nugget * torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    return k


def gram_cuda(kernel, x, x2=None, *, nugget: float = 0.0, center=None):
    """Gram matrix through the CUDA kernel (float32, term-table kernels),
    its coordinates centred on ``center`` (default: ``x``'s mean). On CPU
    tensors this is :func:`gram_reference`."""
    x = as_locations(x)
    if x2 is not None:
        x2 = as_locations(x2)
    if x.device.type == "cpu":
        return gram_reference(kernel, x, x2, nugget, center)
    if not kernel.cuda_supported:
        raise ValueError(f"{type(kernel).__name__} has no CUDA device function")
    _build.require(x, "x", ndim=2, device=x.device)
    if x2 is not None:
        _build.require(x2, "x2", ndim=2, device=x.device)
        if x2.shape[1] != x.shape[1]:
            raise ValueError(f"x2 has D={x2.shape[1]}, x has D={x.shape[1]}")
    return _Gram.apply(kernel, float(nugget), center, x, x2, *leaves(kernel))


gram_cuda.launches = 0


def _launch(kernel, x, x2, nugget, center):
    if center is None:
        center = x.mean(dim=0, keepdim=True)
    x1c = (x - center).contiguous()
    x2c = x1c if x2 is None else (x2 - center).contiguous()
    n, d = x1c.shape
    m = x2c.shape[0]
    table, params = table_tensors(kernel, x.device)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    fn = _build.function("gram", "gpx_gram", _ARGS)
    status = fn(_build.ptr(x1c), _build.ptr(x2c), n, m, d, _build.ptr(table),
                table.shape[0] // COLS, _build.ptr(params), params.shape[0],
                nugget, int(x2 is None), _build.ptr(out), out.stride(0),
                _build.stream(x.device))
    _build.check(status, "gram kernel")
    gram_cuda.launches += 1
    return out


class _Gram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, nugget, center, x, x2, *kernel_leaves):
        ctx.kernel, ctx.nugget, ctx.center = kernel, nugget, center
        ctx.save_for_backward(x, x2, *kernel_leaves)
        return _launch(kernel, x, x2, nugget, center)

    @staticmethod
    def backward(ctx, g):
        x, x2, *kl = ctx.saved_tensors
        with torch.enable_grad():
            kl = [t.detach().requires_grad_() for t in kl]
            xs = [t.detach().requires_grad_() if t is not None else None
                  for t in (x, x2)]
            k = gram_reference(unflatten(ctx.kernel, kl), xs[0], xs[1],
                               ctx.nugget, ctx.center)
            wrt = [t for t in (*xs, *kl) if t is not None]
            grads = iter(torch.autograd.grad(k, wrt, g, allow_unused=True))
        gx = next(grads)
        gx2 = next(grads) if x2 is not None else None
        return (None, None, None, gx, gx2, *grads)
