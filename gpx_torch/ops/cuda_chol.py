"""Blocked Cholesky factor and inverse: the leaf kernel
(``csrc/chol_inv_tile.cu``) and the torch recursion over the product
kernels.

Port of ``gpx/ops/pallas_chol.py::chol_inv_tile`` and of the Schur
recursion ``_rec_value`` / ``_split``::

    chol_inv(A):                       # A = [[A11, .], [A21, A22]]
      L11, M11 = chol_inv(A11)
      L21 = A21 @ M11^T                #   trmm right_lower_t
      S   = A22 - L21 @ L21^T          #   syrk_lower (lower triangle only)
      L22, M22 = chol_inv(S)
      M21 = -M22 @ (L21 @ M11)         #   trmm right_lower (neg) + left_lower

The JAX leaf factors a 2048^2 tile in one program; a Hopper block's shared
memory holds at most a 128^2 tile and its inverse, so the recursion here
goes on down to leaves of at most :data:`LEAF` (one CTA each), launched in
place on their block of the source (:func:`chol_inv_tile_off`).

``chol_inv(a, fast=True)`` runs the outermost M21 (two ``trmm``s) on the
products' 2-pass leg; ``L`` and every other block of ``M`` stay bitwise
those of ``fast=False``.

``chol_inv(a, spine=True)`` is the factorization of the hybrid gradient: it
skips the M21 assembly along the trailing spine, and the solves go through
:func:`spine_solve_lower` / :func:`spine_solve_lower_t`.
"""

from __future__ import annotations

import torch

from gpx_torch._device import full_fp32
from gpx_torch.ops import _build
from gpx_torch.ops.chol import cholesky
from gpx_torch.ops.cuda_trmm import syrk_lower, trmm

LEAF = 128  # csrc/chol_inv_tile.cu: LEAF_MAX
_ARGS = [_build.P, _build.L, _build.P, _build.L, _build.P, _build.L,
         _build.I, _build.P]


def chol_inv_tile_reference(a):
    """``(L, L^-1)`` of the SPD matrix whose lower triangle is ``a``; NaN
    where it is not positive definite (the kernel's negative pivot gives
    NaN too)."""
    sym = torch.tril(a) + torch.tril(a, -1).T
    l = cholesky(sym)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return l, torch.linalg.solve_triangular(l, eye, upper=False)


def chol_inv_tile(a, *, l_out=None, m_out=None):
    """``(L, L^-1)`` of one ``(t, t)`` SPD tile, ``t <= LEAF``, from its
    lower triangle. Both have exact zeros above the diagonal. ``l_out`` /
    ``m_out`` receive them in place; ``l_out`` may be ``a`` itself."""
    t = a.shape[0]
    if a.ndim != 2 or tuple(a.shape) != (t, t) or not 0 < t <= LEAF:
        raise ValueError(f"chol_inv_tile needs a (t, t) tile, t <= {LEAF}: "
                         f"{tuple(a.shape)}")
    for o in (l_out, m_out):
        if o is not None and tuple(o.shape) != (t, t):
            raise ValueError(f"output {tuple(o.shape)} for a ({t}, {t}) tile")
    if a.device.type == "cpu":
        l, m = chol_inv_tile_reference(a)
        if l_out is not None:
            l = l_out.copy_(l)
        if m_out is not None:
            m = m_out.copy_(m)
        return l, m
    dev = a.device
    _build.require(a, "a", ndim=2, device=dev)
    l = torch.empty((t, t), dtype=torch.float32, device=dev) if l_out is None else l_out
    m = torch.empty((t, t), dtype=torch.float32, device=dev) if m_out is None else m_out
    _build.require(l, "l_out", ndim=2, device=dev)
    _build.require(m, "m_out", ndim=2, device=dev)
    fn = _build.function("chol_inv_tile", "gpx_chol_inv_tile", _ARGS)
    status = fn(_build.ptr(a), a.stride(0), _build.ptr(l), l.stride(0),
                _build.ptr(m), m.stride(0), t, _build.stream(dev))
    _build.check(status, "chol_inv_tile")
    chol_inv_tile.launches += 1
    return l, m


chol_inv_tile.launches = 0


def chol_inv_tile_off(src, off: int, t: int, *, l_out=None, m_out=None):
    """:func:`chol_inv_tile` of the ``(t, t)`` diagonal block at ``(off,
    off)`` of ``src``, read in place through its pointer and leading
    dimension (no copy). Its plain version is
    :func:`chol_inv_tile_reference` on that block."""
    if src.ndim != 2 or off < 0 or off + t > min(src.shape):
        raise ValueError(f"block ({off}, {off}) + {t} outside {tuple(src.shape)}")
    blk = slice(off, off + t)
    out = chol_inv_tile(src[blk, blk], l_out=l_out, m_out=m_out)
    if src.device.type == "cuda":
        chol_inv_tile_off.launches += 1
    return out


chol_inv_tile_off.launches = 0


def _split(n: int) -> int:
    """Leading-panel size: half of a power of 2, else the largest power of
    2 below ``n`` (the leaves are then the binary decomposition of ``n``)."""
    return n // 2 if (n & (n - 1)) == 0 else 1 << (n.bit_length() - 1)


def chol_inv(a, *, base: int = LEAF, spine: bool = False, fast: bool = False):
    """``(L, L^-1)`` of an SPD matrix, both lower triangular with exact
    zeros above the diagonal; only the lower triangle of ``a`` is read.

    ``L`` and ``M = L^-1`` start as zeros and every block is written into
    them in place, through views (:func:`_rec`). ``base`` (a power of 2,
    64 to :data:`LEAF`) is the largest leaf. The product kernels' tiles
    do not tie it: ``syrk_lower`` writes element by element on and below
    the diagonal, so nothing lands above a leaf's diagonal block.

    ``spine=True`` skips the M21 assembly at the top level and, recursively,
    in every Schur child: the blocks no later step of the factorization
    reads. They stay exactly zero; ``L`` and every other block of ``M`` are
    bitwise those of ``spine=False``. Solve with :func:`spine_solve_lower`
    and :func:`spine_solve_lower_t` (same ``base``).

    ``fast=True`` (gpx's ``chol_inv(fast=True)``) takes the top level's M21
    assembly, the one block no factor step reads, through ``trmm``'s 2-pass
    leg; it never passes to the children, whose M blocks feed the factor
    (gpx measured a 2-pass factor, and 2-pass M21 at every level, to NaN at
    N = 16k). ``L`` and the other blocks of ``M`` are bitwise those of
    ``fast=False``. For ``n <= base`` the leaf runs as it is: it is FP32 on
    the CUDA cores and has no split to drop. ``spine`` with ``fast`` raises
    ``ValueError``, as in gpx."""
    n = a.shape[-1]
    if a.ndim != 2 or tuple(a.shape) != (n, n) or n == 0:
        raise ValueError(f"chol_inv needs a square matrix: {tuple(a.shape)}")
    if base & (base - 1) or not 64 <= base <= LEAF:
        raise ValueError(f"base must be a power of 2 in [64, {LEAF}]: {base}")
    if spine and fast:
        raise ValueError("spine=True skips the M21 chain that fast=True "
                         "loosens: the two do not combine")
    l = torch.zeros_like(a)
    m = torch.zeros_like(a)
    _rec(a, l, m, 0, n, base, spine, fast)
    return l, m


def _rec(src, l, m, off: int, t: int, base: int, spine: bool = False,
         fast: bool = False):
    """Factor the ``(t, t)`` block at ``(off, off)`` of ``src`` and write its
    L and M blocks into ``l`` and ``m`` at the same place, in place.
    ``src`` is ``a`` along the leading chain and ``l`` for a Schur child,
    whose complement the parent's syrk deposited there. ``spine`` passes to
    the Schur child only: the leading child's full inverse feeds
    ``L21 = A21 M11^T``. ``fast`` (this level's M21 on the 2-pass leg)
    passes to no child."""
    if t <= base:
        blk = slice(off, off + t)
        chol_inv_tile_off(src, off, t, l_out=l[blk, blk], m_out=m[blk, blk])
        return
    h = _split(t)
    s1, s2 = slice(off, off + h), slice(off + h, off + t)
    _rec(src, l, m, off, h, base)
    # a fresh buffer: when src is l, A21 is the block this overwrites
    l21 = trmm(src[s2, s1], m[s1, s1], mode="right_lower_t")
    l[s2, s1].copy_(l21)
    syrk_lower(src[s2, s2], l21, out=l[s2, s2])
    _rec(l, l, m, off + h, t - h, base, spine)
    if not spine:
        t1 = trmm(l21, m[s1, s1], mode="right_lower", neg=True, fast=fast)
        trmm(t1, m[s2, s2], mode="left_lower", fast=fast, out=m[s2, s1])


def spine_solve_lower(l, m, b, *, base: int = LEAF):
    """``L^-1 b`` from ``chol_inv(..., base=base, spine=True)``; ``b`` is
    ``(n,)`` or ``(n, s)``. It follows the factorization's own splits: per
    level ``u1 = M11 b1`` with the leading child's full inverse, then
    ``u2 = spine(b2 - L21 u1)`` down the trailing spine. The products are
    full-float32 ``torch.matmul`` on views of ``l`` and ``m``."""
    full_fp32()
    t = l.shape[0]
    if t <= base:
        return m @ b
    h = _split(t)
    u1 = m[:h, :h] @ b[:h]
    u2 = spine_solve_lower(l[h:, h:], m[h:, h:], b[h:] - l[h:, :h] @ u1,
                           base=base)
    return torch.cat([u1, u2])


def spine_solve_lower_t(l, m, b, *, base: int = LEAF):
    """``L^-T b`` from a spine factorization (see :func:`spine_solve_lower`):
    up the spine, ``x2 = spine_t(b2)`` then ``x1 = M11^T (b1 - L21^T x2)``."""
    full_fp32()
    t = l.shape[0]
    if t <= base:
        return m.T @ b
    h = _split(t)
    x2 = spine_solve_lower_t(l[h:, h:], m[h:, h:], b[h:], base=base)
    x1 = m[:h, :h].T @ (b[:h] - l[h:, :h].T @ x2)
    return torch.cat([x1, x2])
