"""The fused logML gradients (``csrc/logml_grad.cu``,
``csrc/logml_probe_grad.cu``) and their plain versions.

Ports of ``gpx/ops/pallas_logml_grad.py::logml_kernel_grads`` and
``::logml_probe_grads`` with ``with_correction=True``:
``d logML/d theta = sum_ij W_ij dK_ij/d theta`` with
``W = 0.5 (alpha alpha^T - K^-1)``, plus the two traces of the first-order
logdet correction, without K^-1 or W reaching memory. The exact kernel
forms ``K^-1 = L^-T L^-1``; the probe kernel (the hybrid path) its
Hutchinson estimate ``(U Z^T + Z U^T) / (2 s)`` from a probe block ``Z``
and ``U = K^-1 Z``. With ``ard=True`` the coordinates are the ARD-scaled
``u = x / ell`` and both also return ``sdot_d = sum_ij W_ij K'(r2_ij)
(u_id - u_jd)^2``, from which the caller forms the lengthscale gradients
``-2 sdot / ell``. ``logml_kernel_grads(fast=True)`` is gpx's 2-pass leg:
the second operand of each ``K^-1`` product, ``L^-1``'s column block j,
is rounded to TF32 and the first kept whole.

:func:`probe_what_tf32x3` repeats the probe kernel's 3xTF32 product in
float32 arithmetic, for the tests and ``chip_smoke.py`` only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpx_torch.kernels import has_white
from gpx_torch.ops import _build
from gpx_torch.ops.cuda_matvec import tf32x3_product
from gpx_torch.ops.cuda_trmm import round_tf32
from gpx_torch.ops.distance import as_locations, sq_distances
from gpx_torch.ops.terms import COLS, table_tensors
from gpx_torch.params import leaves, unflatten

TILE = 64  # csrc/tile_core.cuh: BM
PROBE_KTILE = 32  # csrc/mma_tf32.cuh: BK, a product's depth rounds up to it
MAX_OUTPUTS = 128  # the JAX package's (1, 128) output tile
_ARGS = [_build.P, _build.L, _build.P, _build.I, _build.P, _build.I,
         _build.P, _build.I, _build.P, _build.I, _build.I, _build.I, _build.P,
         _build.P, _build.P]
_PROBE_ARGS = [_build.P, _build.L, _build.P, _build.L, _build.I, _build.P,
               _build.I, _build.P, _build.I, _build.P, _build.I, _build.P,
               _build.I, _build.I, _build.P, _build.P, _build.P]


def _check_outputs(kernel, x, ard: bool) -> None:
    n_out = len(leaves(kernel)) + 2 + (x.shape[1] if ard else 0)
    if n_out > MAX_OUTPUTS:
        raise ValueError(f"{n_out} fused-gradient outputs: more than "
                         f"{MAX_OUTPUTS}")


def _contract_reference(kernel, x, alpha, kinv, ard: bool):
    """Forms ``W`` from a (exact or estimated) ``K^-1`` and contracts it
    with the kernel's tangents by autograd of ``evaluate_r2``; with
    ``ard``, also with ``dK/dr2`` and the squared coordinate differences."""
    x = as_locations(x)
    w = 0.5 * (torch.outer(alpha, alpha) - kinv)
    r2 = sq_distances(x, exact=x.shape[-1] > 8 and has_white(kernel))
    with torch.enable_grad():
        kl = [t.detach().requires_grad_() for t in leaves(kernel)]
        r2 = r2.detach().requires_grad_(ard)
        kval = unflatten(kernel, kl).evaluate_r2(r2)
        grads = torch.autograd.grad(torch.sum(w * kval),
                                    kl + ([r2] if ard else []))
    kval = kval.detach()
    d_kernel = unflatten(kernel, list(grads[:len(kl)]))
    out = (d_kernel, (torch.sum(kinv * kval), torch.trace(kinv)))
    if ard:
        wk = grads[-1]
        out += (torch.stack([torch.sum(wk * (x[:, e, None] - x[None, :, e]) ** 2)
                             for e in range(x.shape[1])]),)
    return out


def logml_kernel_grads_reference(kernel, x, alpha, l_inv, *, ard: bool = False,
                                 fast: bool = False):
    """Plain version: forms ``K^-1`` and ``W`` explicitly. With ``fast`` its
    entry (i, j), i >= j, is ``sum_k l_inv[k, i] round_tf32(l_inv[k, j])``
    (:func:`round_tf32`), mirrored above the diagonal, as the kernel reads
    it."""
    if not fast:
        return _contract_reference(kernel, x, alpha, l_inv.T @ l_inv, ard)
    p = l_inv.T @ round_tf32(l_inv)
    kinv = torch.tril(p) + torch.tril(p, -1).T
    return _contract_reference(kernel, x, alpha, kinv, ard)


def _prepare(kernel, x, alpha, mats, ard):
    """Checks of a CUDA launch; returns ``(centred x, table, params,
    partials, out)``."""
    if not kernel.cuda_supported:
        raise ValueError(f"{type(kernel).__name__} has no CUDA device function")
    n = x.shape[0]
    if n % TILE:
        raise ValueError(f"n = {n} must be a multiple of {TILE}")
    dev = x.device
    for t, name, nd in ((x, "x", 2), (alpha, "alpha", 1), *mats):
        _build.require(t, name, ndim=nd, device=dev)
    xc = (x - x.mean(dim=0, keepdim=True)).contiguous()
    table, params = table_tensors(kernel, dev)
    n_out = params.shape[0] + 2 + (x.shape[1] if ard else 0)
    nb = n // TILE
    partials = torch.empty((nb * (nb + 1) // 2, n_out), dtype=torch.float32,
                           device=dev)
    out = torch.empty((n_out,), dtype=torch.float32, device=dev)
    return xc, table, params, partials, out


def _unpack(kernel, out, ard):
    n_params = len(leaves(kernel))
    grads = [out[p].reshape(leaf.shape) for p, leaf in enumerate(leaves(kernel))]
    res = (unflatten(kernel, grads), (out[n_params], out[n_params + 1]))
    return res + (out[n_params + 2:],) if ard else res


def logml_kernel_grads(kernel, x, alpha, l_inv, *, ard: bool = False,
                       fast: bool = False):
    """``(d_kernel, (tkw, trw))``: the logML gradient for every kernel
    hyperparameter (a tree shaped like ``kernel``), ``tkw = tr(W_hat K)``
    with K taken without the nugget, and ``trw = tr(W_hat)``, where
    ``W_hat = l_inv^T l_inv``; with ``ard=True`` (``x`` the ARD-scaled
    coordinates) ``(d_kernel, (tkw, trw), sdot)``, ``sdot`` of shape
    ``(D,)``. At most 128 outputs (hyperparameters + 2 + D). ``fast`` runs
    the ``K^-1`` products on the 2-pass leg. On the card ``n`` must be a
    multiple of :data:`TILE`. On CPU tensors this is the plain version."""
    x = as_locations(x)
    n = x.shape[0]
    if tuple(l_inv.shape) != (n, n) or tuple(alpha.shape) != (n,):
        raise ValueError(f"l_inv {tuple(l_inv.shape)} / alpha "
                         f"{tuple(alpha.shape)} for n = {n}")
    _check_outputs(kernel, x, ard)
    if x.device.type == "cpu":
        return logml_kernel_grads_reference(kernel, x, alpha, l_inv, ard=ard,
                                            fast=fast)
    xc, table, params, partials, out = _prepare(kernel, x, alpha,
                                                [(l_inv, "l_inv", 2)], ard)
    fn = _build.function("logml_grad", "gpx_logml_grad", _ARGS)
    status = fn(_build.ptr(l_inv), l_inv.stride(0), _build.ptr(xc),
                xc.shape[1], _build.ptr(alpha), n, _build.ptr(table),
                table.shape[0] // COLS, _build.ptr(params), params.shape[0],
                int(ard), int(fast), _build.ptr(partials), _build.ptr(out),
                _build.stream(x.device))
    _build.check(status, "logml_kernel_grads")
    logml_kernel_grads.launches += 1
    logml_kernel_grads.fast_launches += fast
    return _unpack(kernel, out, ard)


logml_kernel_grads.launches = 0
logml_kernel_grads.fast_launches = 0  # of them on the 2-pass leg


def logml_probe_grads_reference(kernel, x, alpha, u, z, *, ard: bool = False):
    """Plain version: forms ``what = (U Z^T + Z U^T) / (2 s)``, then ``W``
    and its contraction, explicitly."""
    what = (u @ z.T + z @ u.T) * (0.5 / z.shape[1])
    return _contract_reference(kernel, x, alpha, what, ard)


def probe_what_tf32x3(u, z, *, passes: int = 3):
    """``what = (U Z^T + Z U^T) (0.5 / s)`` from float32 ``u`` and ``z``
    ``(n, s)`` as ``csrc/logml_probe_grad.cu`` forms it: one 2s-deep
    product of ``A = [U | Z]`` and ``B = [Z | U]``, each half padded with
    zeros to whole 32-deep k-tiles, in the TF32 arithmetic of
    :func:`tf32x3_product` (the same 64-deep slabs as the kernel's core,
    ``csrc/mma_tf32.cuh``; ``passes=3``: lo*hi + hi*lo + hi*hi, 1: hi*hi
    alone), then scaled by ``0.5 / s`` in float32. For the tests and
    ``chip_smoke.py`` only."""
    s = u.shape[1]
    pad = (-s) % PROBE_KTILE
    a = torch.cat([F.pad(u, (0, pad)), F.pad(z, (0, pad))], dim=1)
    b = torch.cat([F.pad(z, (0, pad)), F.pad(u, (0, pad))], dim=1)
    what = tf32x3_product(a, b.T, passes=passes)
    return what * torch.tensor(0.5 / s, dtype=torch.float32)


def logml_probe_grads_tf32x3(kernel, x, alpha, u, z, *, ard: bool = False,
                             passes: int = 3):
    """:func:`logml_probe_grads_reference` with ``W_hat`` from
    :func:`probe_what_tf32x3`, contracted in the dtype of ``x``: the probe
    kernel's product, and a plain contraction."""
    what = probe_what_tf32x3(u.float(), z.float(), passes=passes)
    return _contract_reference(kernel, x, alpha, what.to(x.dtype), ard)


def logml_probe_grads(kernel, x, alpha, u, z, *, ard: bool = False):
    """``(d_kernel, (tkw, trw))`` (and ``sdot`` with ``ard=True``) as
    :func:`logml_kernel_grads` returns them, with ``W_hat`` the Hutchinson
    estimate ``(U Z^T + Z U^T) / (2 s)`` of ``K^-1`` from an ``(n, s)``
    probe block ``z`` and ``u = K^-1 z``, ``s >= 1``: O(n^2 s) work instead
    of the exact kernel's n^3/6. On the card ``n`` must be a multiple of
    :data:`TILE`. On CPU tensors this is the plain version."""
    x = as_locations(x)
    n = x.shape[0]
    if (u.ndim != 2 or tuple(u.shape) != tuple(z.shape) or u.shape[0] != n
            or u.shape[1] < 1 or tuple(alpha.shape) != (n,)):
        raise ValueError(f"u {tuple(u.shape)} / z {tuple(z.shape)} / alpha "
                         f"{tuple(alpha.shape)} for n = {n}")
    _check_outputs(kernel, x, ard)
    if x.device.type == "cpu":
        return logml_probe_grads_reference(kernel, x, alpha, u, z, ard=ard)
    xc, table, params, partials, out = _prepare(
        kernel, x, alpha, [(u, "u", 2), (z, "z", 2)], ard)
    fn = _build.function("logml_probe_grad", "gpx_logml_probe_grad",
                         _PROBE_ARGS)
    status = fn(_build.ptr(u), u.stride(0), _build.ptr(z), z.stride(0),
                u.shape[1], _build.ptr(xc), xc.shape[1], _build.ptr(alpha), n,
                _build.ptr(table), table.shape[0] // COLS, _build.ptr(params),
                params.shape[0], int(ard), _build.ptr(partials),
                _build.ptr(out), _build.stream(x.device))
    _build.check(status, "logml_probe_grads")
    logml_probe_grads.launches += 1
    return _unpack(kernel, out, ard)


logml_probe_grads.launches = 0
