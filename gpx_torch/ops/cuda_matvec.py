"""The matrix-free Gram products (``csrc/matvec.cu``) and their plain
versions.

Ports of ``gpx/ops/pallas_matvec.py::gram_matvec`` and ``::cross_matvec``:
``(K(x, x) + nugget I) V`` and ``K(x1, x2) V`` with the Gram entries
rebuilt on the fly and never stored. The wrappers take the plain versions
only for CPU tensors; for CUDA tensors they launch the kernel or raise.
The caller centres the coordinates (:mod:`gpx_torch.ops.matvec`).

The plain versions (:func:`_gram_matvec_torch`, :func:`_cross_matvec_torch`)
work in row blocks, each under ``torch.utils.checkpoint``, so that autograd
through them recomputes a block instead of storing O(N^2) residuals: they
are the differentiable route of the hyperparameter gradient, as
``_gram_matvec_xla`` is in the JAX package. Their TF32 twins
(:func:`_gram_matvec_tf32x3_torch`, :func:`_cross_matvec_tf32x3_torch`)
repeat the kernel's split products in float32, for the tests and
``chip_smoke.py`` only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpx_torch.kernels import has_white
from gpx_torch.ops import _build
from gpx_torch.ops.distance import sq_distances
from gpx_torch.ops.terms import COLS, table_tensors
from gpx_torch.params import leaves

_ARGS = [_build.P, _build.P, _build.I, _build.I, _build.I, _build.P, _build.L,
         _build.I, _build.P, _build.I, _build.P, _build.I, _build.F, _build.I,
         _build.P, _build.P, _build.L, _build.P]
_SPLIT_ARGS = [_build.I] * 6


def _checkpointed(kernel, *tensors):
    """How a row block runs: under ``checkpoint`` where autograd records
    through it (its first call imports torch.distributed's tensor layer,
    ~2 s on the CPU), else plainly."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*tensors, *leaves(kernel))):
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)
    return lambda fn, *args: fn(*args)


def _gram_matvec_torch(kernel, x, v2, nugget, block: int = 2048):
    """``(K(x, x) + nugget I) @ v2`` in row blocks of ``block`` rows, each
    checkpointed: O(block N) memory, differentiable in the kernel's
    hyperparameters. The exact-zero diagonal is restored in every block
    (White fires there) and the nugget added on it."""
    _gram_matvec_torch.calls += 1
    n = x.shape[0]
    exact = x.shape[1] > 8 and has_white(kernel)
    cols = torch.arange(n, device=x.device)

    def row_block(xb, i0):
        diag = (i0 + torch.arange(xb.shape[0], device=x.device))[:, None] \
            == cols[None, :]
        r2 = torch.where(diag, 0.0, sq_distances(xb, x, exact=exact))
        kb = kernel.evaluate_xx(xb, x, r2)
        if nugget:
            kb = torch.where(diag, kb + nugget, kb)
        return kb @ v2

    run = _checkpointed(kernel, x, v2)
    return torch.cat([run(row_block, x[i0:i0 + block], i0)
                      for i0 in range(0, n, block)])


_gram_matvec_torch.calls = 0


def _cross_matvec_torch(kernel, x1, x2, v2, block: int = 2048):
    """``K(x1, x2) @ v2`` in checkpointed row blocks of ``x1``: no nugget
    and no forced diagonal (duplicates across the sets still meet White
    through exact zero distances)."""
    exact = x1.shape[1] > 8 and has_white(kernel)

    def row_block(xb):
        r2 = torch.clamp_min(sq_distances(xb, x2, exact=exact), 0.0)
        return kernel.evaluate_xx(xb, x2, r2) @ v2

    run = _checkpointed(kernel, x1, x2, v2)
    return torch.cat([run(row_block, x1[i0:i0 + block])
                      for i0 in range(0, x1.shape[0], block)])


# the k between two folds: csrc/matvec.cu's MV_BK, csrc/mma_tf32.cuh's
# SLAB_TILES * BK
SLAB = 64


def tf32_split(a):
    """``(hi, lo)`` of float32 ``a``: ``a = hi + lo + O(2^-22 |a|)``, both
    rounded to TF32 to nearest, ties away (``csrc/mma_tf32.cuh``'s
    ``split``)."""
    hi = ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = (((a - hi).view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, lo


def tf32x3_product(kb, v2, passes: int = 4):
    """``kb @ v2`` as the kernels form it from float32 ``kb`` (rows, N2) and
    ``v2`` (N2, R): both split into TF32 hi/lo, the products lo*lo + lo*hi
    + hi*lo + hi*hi (``passes`` < 4 keeps the last ones: 1 is hi*hi
    alone), each 64-deep slab summed and rounded to float32, the slabs
    summed in float64 and the result rounded to float32. The matvec's
    plain versions and the probe kernel's (``cuda_logml_grad``) use it."""
    pad = (-kb.shape[1]) % SLAB
    (kh, kl), (vh, vl) = tf32_split(kb), tf32_split(v2)
    pairs = ((kl, vl), (kl, vh), (kh, vl), (kh, vh))[4 - passes:]
    slabs = 0.0
    for a, b in pairs:
        a = F.pad(a.double(), (0, pad)).unflatten(1, (-1, SLAB)).transpose(0, 1)
        b = F.pad(b.double(), (0, 0, 0, pad)).unflatten(0, (-1, SLAB))
        slabs = slabs + a @ b                          # (slabs, rows, R)
    return slabs.float().double().sum(dim=0).float()


def _tf32x3_rows(n2: int, d: int, r: int) -> int:
    """Rows per block of the TF32 plain versions: ~32 MiB of slab sums and
    ~256 MiB of coordinate differences."""
    return max(1, min(2048, (1 << 22) // (-(-n2 // SLAB) * r),
                      (1 << 26) // (n2 * d)))


def _r2_as_kernel(xb, x2):
    """Squared distances as the kernel forms them: broadcast differences
    of the coordinates as given (no centring of the block), at any D."""
    diff = xb[:, None, :] - x2[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _gram_matvec_tf32x3_torch(kernel, x, v2, nugget, *, rows=None,
                              passes: int = 4):
    """``(K(x, x) + nugget I) @ v2`` in float32 with the kernel's TF32
    arithmetic (:func:`tf32x3_product`), for the first ``rows`` rows (all
    by default): the CUDA kernel's second witness beside float64, for the
    tests and ``chip_smoke.py``. ``x`` is centred, as the kernel takes
    it."""
    n = x.shape[0] if rows is None else rows
    block = _tf32x3_rows(*x.shape, v2.shape[1])
    cols = torch.arange(x.shape[0], device=x.device)
    out = []
    with torch.no_grad():
        for i0 in range(0, n, block):
            xb = x[i0:min(n, i0 + block)]
            diag = (i0 + torch.arange(xb.shape[0], device=x.device))[:, None] \
                == cols[None, :]
            r2 = torch.where(diag, 0.0, _r2_as_kernel(xb, x))
            kb = kernel.evaluate_xx(xb, x, r2)
            kb = torch.where(diag, kb + nugget, kb)
            out.append(tf32x3_product(kb, v2, passes))
    return torch.cat(out)


def _cross_matvec_tf32x3_torch(kernel, x1, x2, v2, *, passes: int = 4):
    """``K(x1, x2) @ v2`` with the kernel's TF32 arithmetic, as
    :func:`_gram_matvec_tf32x3_torch`, for ``x1`` and ``x2`` centred
    together."""
    block = _tf32x3_rows(*x2.shape, v2.shape[1])
    out = []
    with torch.no_grad():
        for i0 in range(0, x1.shape[0], block):
            xb = x1[i0:i0 + block]
            kb = kernel.evaluate_xx(xb, x2, _r2_as_kernel(xb, x2))
            out.append(tf32x3_product(kb, v2, passes))
    return torch.cat(out)


def gram_matvec_cuda(kernel, x, v2, *, nugget: float = 0.0):
    """``(K(x, x) + nugget I) @ v2`` through the CUDA kernel, for centred
    float32 ``x`` (N, D) and ``v2`` (N, R). On CPU tensors this is
    :func:`_gram_matvec_torch`."""
    if x.device.type == "cpu":
        return _gram_matvec_torch(kernel, x, v2, nugget)
    return _launch(kernel, x, x, v2, nugget, symmetric=True)


gram_matvec_cuda.launches = 0


def cross_matvec_cuda(kernel, x1, x2, v2):
    """``K(x1, x2) @ v2`` through the CUDA kernel, for float32 ``x1``
    (N1, D), ``x2`` (N2, D) centred together and ``v2`` (N2, R). On CPU
    tensors this is :func:`_cross_matvec_torch`."""
    if x1.device.type == "cpu":
        return _cross_matvec_torch(kernel, x1, x2, v2)
    return _launch(kernel, x1, x2, v2, 0.0, symmetric=False)


cross_matvec_cuda.launches = 0


def _launch(kernel, x1, x2, v2, nugget, *, symmetric):
    """Checks, then one launch of ``gpx_matvec`` (and its fixed-order sum
    of the column splits); returns ``(N1, R)`` float32."""
    if not kernel.cuda_supported:
        raise ValueError(f"{type(kernel).__name__} has no CUDA device function")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x1, x2, v2, *leaves(kernel))):
        raise ValueError("the CUDA matvec has no gradient: differentiate "
                         "through _gram_matvec_torch / _cross_matvec_torch")
    dev = x1.device
    x1, x2, v2 = x1.contiguous(), x2.contiguous(), v2.contiguous()
    _build.require(x1, "x1", ndim=2, device=dev)
    _build.require(x2, "x2", ndim=2, device=dev)
    _build.require(v2, "v", ndim=2, device=dev)
    n1, d = x1.shape
    n2, r = v2.shape
    if x2.shape != (n2, d):
        raise ValueError(f"x2 {tuple(x2.shape)} for v {tuple(v2.shape)} and "
                         f"D = {d}")
    out = torch.empty((n1, r), dtype=torch.float32, device=dev)
    if n1 == 0 or r == 0:
        return out
    if n2 == 0:
        return out.zero_()
    table, params = table_tensors(kernel, dev)
    n_terms = table.shape[0] // COLS
    splits = _build.function("matvec", "gpx_matvec_splits", _SPLIT_ARGS)(
        n1, n2, r, d, n_terms, params.shape[0])
    partials = torch.empty((splits, n1, r), dtype=torch.float64, device=dev)
    fn = _build.function("matvec", "gpx_matvec", _ARGS)
    status = fn(_build.ptr(x1), _build.ptr(x2), n1, n2, d, _build.ptr(v2),
                v2.stride(0), r, _build.ptr(table), n_terms,
                _build.ptr(params), params.shape[0], float(nugget),
                int(symmetric), _build.ptr(partials), _build.ptr(out),
                out.stride(0), _build.stream(dev))
    _build.check(status, "gram_matvec" if symmetric else "cross_matvec")
    (gram_matvec_cuda if symmetric else cross_matvec_cuda).launches += 1
    return out
