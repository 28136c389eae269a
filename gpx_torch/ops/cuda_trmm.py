"""Triangular products (``csrc/trmm.cu``) and their plain versions.

Port of ``gpx/ops/pallas_trmm.py::trmm`` and ``::syrk_lower``. Operands are
float32 matrices or views of them with a leading dimension (unit stride
along rows), so the Cholesky recursion passes blocks of its full-size
buffers and the kernels write into them in place (``out=``) — where the
JAX package passed tile offsets (``b_off``/``l_off``/``a_off``) and
assembled new arrays. ``L`` must hold exact zeros above its diagonal: the
kernels skip its zero tiles but read the diagonal tiles whole.

``fast=True`` is the port of gpx's 2-pass leg (``_dot_bf16x2``): the
kernel's right operand (``l`` in ``right_lower``, ``b`` in
``left_lower``) is rounded to TF32 and the left one kept whole, about
2^-11 relative per product. ``chol_inv(fast=True)`` takes it for its
outermost M21 only; ``right_lower_t`` and ``syrk_lower`` have no fast leg.
"""

from __future__ import annotations

import torch

from gpx_torch.ops import _build

MODES = {"right_lower": 0, "left_lower": 1, "right_lower_t": 2}
_TRMM_ARGS = [_build.P, _build.L, _build.P, _build.L, _build.P, _build.L,
              _build.I, _build.I, _build.I, _build.I, _build.F, _build.I,
              _build.P]
_SYRK_ARGS = [_build.P, _build.L, _build.P, _build.L, _build.P, _build.L,
              _build.I, _build.I, _build.P]


def round_tf32(t):
    """``t`` rounded to TF32 as the kernels' split rounds it: on the float32
    bits, to nearest with ties away from zero (the low 13 mantissa bits
    cleared), returned in ``t``'s dtype."""
    bits = t.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32).to(t.dtype)


def _trmm_shape(b, l, mode, fast=False):
    if mode not in MODES:
        raise ValueError(f"unknown trmm mode: {mode}")
    if fast and mode == "right_lower_t":
        raise ValueError("fast=True is for right_lower and left_lower only")
    n = l.shape[0]
    if l.ndim != 2 or l.shape != (n, n) or b.ndim != 2:
        raise ValueError(f"trmm {mode}: l {tuple(l.shape)}, b {tuple(b.shape)}")
    if mode == "left_lower":
        if b.shape[0] != n:
            raise ValueError(f"left_lower: b {tuple(b.shape)} for l ({n}, {n})")
        return (n, b.shape[1])
    if b.shape[1] != n:
        raise ValueError(f"{mode}: b {tuple(b.shape)} for l ({n}, {n})")
    return (b.shape[0], n)


def trmm_reference(b, l, *, mode: str, neg: bool = False, fast: bool = False):
    """``b @ L`` / ``L @ b`` / ``b @ L^T`` with ``L = tril(l)``; with
    ``fast`` the right operand rounded to TF32 (:func:`round_tf32`) and the
    product of full and rounded operands in the inputs' precision."""
    _trmm_shape(b, l, mode, fast)
    lt = torch.tril(l)
    if mode == "right_lower":
        c = b @ (round_tf32(lt) if fast else lt)
    elif mode == "left_lower":
        c = lt @ (round_tf32(b) if fast else b)
    else:
        c = b @ lt.T
    return -c if neg else c


def trmm(b, l, *, mode: str, neg: bool = False, fast: bool = False,
         out=None):
    """``b @ l`` (``right_lower``), ``l @ b`` (``left_lower``) or
    ``b @ l.T`` (``right_lower_t``), ``l`` lower triangular ``(n, n)``;
    ``b`` is ``(m, n)`` in the right modes and ``(n, m)`` in
    ``left_lower``. ``neg`` writes ``-C``; ``fast`` rounds the right
    operand to TF32 (not in ``right_lower_t``). ``out`` (a matrix or a
    view) receives the result in place; it must not overlap ``b`` or
    ``l``."""
    shape = _trmm_shape(b, l, mode, fast)
    if out is not None and tuple(out.shape) != shape:
        raise ValueError(f"out {tuple(out.shape)} for a {shape} product")
    if b.device.type == "cpu":
        c = trmm_reference(b, l, mode=mode, neg=neg, fast=fast)
        return c if out is None else out.copy_(c)
    dev = b.device
    _build.require(b, "b", ndim=2, device=dev)
    _build.require(l, "l", ndim=2, device=dev)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    _build.require(out, "out", ndim=2, device=dev)
    a_op, b_op = (l, b) if mode == "left_lower" else (b, l)
    k = l.shape[0]
    fn = _build.function("trmm", "gpx_trmm", _TRMM_ARGS)
    status = fn(_build.ptr(a_op), a_op.stride(0), _build.ptr(b_op),
                b_op.stride(0), _build.ptr(out), out.stride(0), shape[0],
                shape[1], k, MODES[mode], -1.0 if neg else 1.0, int(fast),
                _build.stream(dev))
    _build.check(status, f"trmm {mode}")
    trmm.launches += 1
    trmm.fast_launches += fast
    return out


trmm.launches = 0
trmm.fast_launches = 0  # of them on the 2-pass leg


def syrk_lower_reference(a, b):
    """``tril(a - b @ b.T)``."""
    return torch.tril(a - b @ b.T)


def syrk_lower(a, b, *, out=None):
    """``a - b @ b.T`` on the lower triangle, ``b`` of shape ``(n, k)``.

    Only the lower triangle of the result is defined: the kernel writes
    each element with ``i >= j`` and leaves every other element of ``out``
    as it was (a new ``out`` starts at zero), whatever its tile size.
    ``out`` may be ``a`` itself or the same block of it."""
    n = b.shape[0]
    if b.ndim != 2 or a.ndim != 2 or tuple(a.shape) != (n, n):
        raise ValueError(f"syrk_lower: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if out is not None and tuple(out.shape) != (n, n):
        raise ValueError(f"out {tuple(out.shape)} for ({n}, {n})")
    if b.device.type == "cpu":
        s = syrk_lower_reference(a, b)
        if out is None:
            return s
        lower = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        return out.copy_(torch.where(lower, s, out))
    dev = b.device
    _build.require(a, "a", ndim=2, device=dev)
    _build.require(b, "b", ndim=2, device=dev)
    if out is None:
        out = torch.zeros((n, n), dtype=torch.float32, device=dev)
    _build.require(out, "out", ndim=2, device=dev)
    fn = _build.function("trmm", "gpx_syrk_lower", _SYRK_ARGS)
    status = fn(_build.ptr(a), a.stride(0), _build.ptr(b), b.stride(0),
                _build.ptr(out), out.stride(0), n, b.shape[1],
                _build.stream(dev))
    _build.check(status, "syrk_lower")
    syrk_lower.launches += 1
    return out


syrk_lower.launches = 0
