"""Distributed blocked Cholesky and logML over a mesh axis — the port of
``gpx/parallel/dist_chol.py``.

K is row-block sharded over the ranks of ``mesh[axis]`` and factorized by
a right-looking panel algorithm (width ``panel``). Per panel:

1. every rank's rows of the panel's columns are all-gathered (N x panel:
   the only matrix data that moves);
2. every rank factors the (panel, panel) diagonal block and solves the
   rows below it that its own rows need (``torch.linalg``, TF32 off, as
   the JAX package asks for ``Precision.HIGHEST``);
3. each rank applies the rank-``panel`` update to its own live rows over
   the live trailing columns ``[e, end of its rows)``: the O(N^3) bulk.

The JAX package updates a fixed column slab per stage and masks what is
finished, because XLA needs static shapes; here the loop is Python and
slices the live block directly, so each rank computes only the lower
triangle of its rows. A rank knows its coordinate on the host, so the
solves branch on the panel's owner there: a rank that does not own the
panel solves nothing (the JAX package swaps in the identity for the same
reason, to keep NaN out of the backward pass) and sends zeros to the
``psum``.

A row-sharded array of the JAX package is a ``DTensor`` with placement
``Shard(0)`` on ``mesh[axis]`` here (``to_local()`` gives the rank's
rows); an array the JAX package takes whole (``x``, ``y``, ``b``) every
rank passes whole, and a replicated result is the same tensor on every
rank. The per-rank bodies (``chol_body``, ``half_logdet_body``,
``forward_solve_body``, ``logml_body``) take the rank's block, the mesh
and the axis, and an optional leading batch dimension.

The gradient (:func:`distributed_logml_value_and_grad`) is autograd
through the panel program with the collectives' transposes of
:mod:`gpx_torch.parallel.comm`. The JAX package's ``_dlvg_jitted`` and its
AOT executable cache are compile caches; the port compiles nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpx_torch._device import full_fp32
from gpx_torch.ops.chol import cholesky
from gpx_torch.ops.distance import as_locations
from gpx_torch.params import leaves, unflatten
from gpx_torch.parallel import comm

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _block(mesh, axis: str, n: int):
    """``(row0, rows_per)``: this rank's first global row and row count."""
    rows_per = n // comm.axis_size(mesh, axis)
    return comm.axis_index(mesh, axis) * rows_per, rows_per


def _check(n: int, d: int, panel: int) -> None:
    if n % d or (n // d) % panel:
        raise ValueError(f"N={n} must split into {d} row shards of "
                         f"panel-multiple size (panel={panel})")


def local(t, mesh=None, axis: str = "data"):
    """This rank's rows of ``t``: a ``DTensor``'s local block, or the
    rank's row block of a whole tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        return t.to_local()
    row0, rows_per = _block(mesh, axis, t.shape[0])
    return t[row0:row0 + rows_per]


def sharded(t_loc, mesh, axis: str = "data", *, dim: int = 0):
    """The ``DTensor`` whose rank blocks along ``dim`` are each rank's
    ``t_loc`` on ``mesh[axis]`` (replicated over the other mesh axes)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(dim) if name == axis else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(t_loc, mesh, placements, run_check=False)


def distributed_cholesky(k, mesh, *, axis: str = "data", panel: int = 128):
    """Lower Cholesky factor of SPD ``k`` (a row-sharded ``DTensor``, or
    the whole matrix on every rank) over ``mesh[axis]``; returns the
    row-sharded factor. Requires ``N % d == 0`` and ``(N / d) % panel ==
    0``: a panel never straddles two ranks."""
    full_fp32()
    n = k.shape[-1]
    _check(n, comm.axis_size(mesh, axis), panel)
    l_loc = chol_body(local(k, mesh, axis), mesh=mesh, axis=axis, n=n,
                      panel=panel)
    return sharded(l_loc, mesh, axis)


def chol_body(k_loc, *, mesh, axis: str, n: int, panel: int = 128):
    """This rank's rows (``(..., N/d, N)``) of the lower factor of the
    matrix whose rows ``k_loc`` holds, the rank-local program of
    :func:`distributed_cholesky`; every rank of ``mesh[axis]`` calls it."""
    return torch.cat(_chol_panels(k_loc, mesh=mesh, axis=axis, n=n,
                                  panel=panel), dim=-1)


def _chol_panels(k_loc, *, mesh, axis: str, n: int, panel: int):
    """:func:`chol_body`'s factor as its list of panel column blocks
    (``(..., N/d, panel)`` each), which the solves and the logdet take as
    they are: autograd then never slices the whole (N/d, N) factor, whose
    every slice's backward would fill and add a gradient of its size."""
    row0, rows_per = _block(mesh, axis, n)
    hi = row0 + rows_per
    batch = k_loc.shape[:-2]
    # the live block: own rows [max(row0, s), hi) x columns [s, hi)
    a = k_loc[..., :, :hi]
    cols = []
    for s in range(0, n, panel):
        e = s + panel
        lo = max(row0, s)
        if s < hi:
            col, a = a.split([panel, a.shape[-1] - panel], dim=-1)
            col = F.pad(col, (0, 0, lo - row0, 0))       # rows above s: dead
        else:
            col = k_loc.new_zeros((*batch, rows_per, panel))
        full = comm.all_gather(col, mesh, axis, dim=-2)   # (..., N, panel)
        l_pp = cholesky(full[..., s:e, :])
        # L[r, panel] = A[r, panel] L_pp^-T for the rows [e, hi) this rank
        # needs: its own rows and the columns of its trailing update
        sol = torch.linalg.solve_triangular(
            l_pp, full[..., e:max(e, hi), :].mT, upper=False).mT
        r = max(row0, e)
        parts = []
        if min(s, hi) > row0:
            parts.append(k_loc.new_zeros((*batch, min(s, hi) - row0, panel)))
        if row0 <= s < hi:
            parts.append(l_pp)
        parts.append(sol[..., r - e:, :])
        cols.append(torch.cat(parts, dim=-2))
        if e < hi:
            a = a[..., r - lo:, :] - sol[..., r - e:, :] @ sol.mT
    return cols


def distributed_half_logdet(l_sharded, mesh, *, axis: str = "data"):
    """``sum log diag(L)`` with L row-sharded: each rank's diagonal, then a
    ``psum``; replicated."""
    return half_logdet_body(local(l_sharded, mesh, axis), mesh=mesh,
                            axis=axis)


def half_logdet_body(l_loc, *, mesh, axis: str):
    """The rank-local program of :func:`distributed_half_logdet`; ``l_loc``
    is the rank's rows of L or their panel column blocks."""
    my = comm.axis_index(mesh, axis)
    if isinstance(l_loc, (list, tuple)):
        rows_per, panel = l_loc[0].shape[-2:]
        own = l_loc[my * (rows_per // panel):(my + 1) * (rows_per // panel)]
        diag = torch.cat([torch.diagonal(c[..., i * panel:(i + 1) * panel, :],
                                         dim1=-2, dim2=-1)
                          for i, c in enumerate(own)], dim=-1)
    else:
        rows_per = l_loc.shape[-2]
        diag = torch.diagonal(l_loc[..., :, my * rows_per:(my + 1) * rows_per],
                              dim1=-2, dim2=-1)
    return comm.psum(torch.sum(torch.log(diag), dim=-1), mesh, axis)


def _check_rows(n: int, d: int, panel: int) -> None:
    if (n // d) % panel:
        raise ValueError("panel must divide the per-device row count")


def distributed_forward_solve(l_sharded, b, mesh, *, axis: str = "data",
                              panel: int = 128):
    """Solve ``L u = b`` with L row-sharded and ``b`` whole: panel by
    panel, one ``psum`` of ``panel`` values each. Replicated."""
    full_fp32()
    n = l_sharded.shape[-1]
    _check_rows(n, comm.axis_size(mesh, axis), panel)
    return forward_solve_body(local(l_sharded, mesh, axis), b, mesh=mesh,
                              axis=axis, n=n, panel=panel)


def forward_solve_body(l_loc, b_rep, *, mesh, axis: str, n: int,
                       panel: int = 128):
    """The rank-local program of :func:`distributed_forward_solve`;
    ``b_rep`` (``(..., N)``) is replicated; ``l_loc`` is the rank's rows of
    L or their panel column blocks."""
    row0, rows_per = _block(mesh, axis, n)
    hi = row0 + rows_per
    owner_of = rows_per // panel
    my = comm.axis_index(mesh, axis)
    cols = (l_loc if isinstance(l_loc, (list, tuple))
            else l_loc.split(panel, dim=-1))    # one autograd node
    z = b_rep[..., row0:hi]              # the residual of this rank's rows
    us = []
    for p in range(n // panel):
        s, e = p * panel, (p + 1) * panel
        if p // owner_of == my:
            off = s - row0
            cand = torch.linalg.solve_triangular(
                cols[p][..., off:off + panel, :], z[..., off:off + panel, None],
                upper=False)[..., 0]
        else:
            cand = z.new_zeros((*z.shape[:-1], panel))
        u_p = comm.psum(cand, mesh, axis)
        us.append(u_p)
        if e < hi:
            z = z - (cols[p] @ u_p[..., None])[..., 0]
    return torch.cat(us, dim=-1)


def distributed_back_solve(l_sharded, b, mesh, *, axis: str = "data",
                           panel: int = 128):
    """Solve ``L^T a = b`` with L row-sharded and ``b`` whole, in a reverse
    panel sweep. The panel's owner solves its block and forms the update
    of the earlier residual entries from its own rows of L (its rows are
    the columns of ``L^T`` it needs: no matrix data moves); one ``psum``
    carries both. Replicated."""
    full_fp32()
    n = l_sharded.shape[-1]
    d = comm.axis_size(mesh, axis)
    _check_rows(n, d, panel)
    l_loc = local(l_sharded, mesh, axis)
    row0, rows_per = _block(mesh, axis, n)
    owner_of = rows_per // panel
    my = comm.axis_index(mesh, axis)
    z = b
    parts = []
    for p in reversed(range(n // panel)):
        s, e = p * panel, (p + 1) * panel
        if p // owner_of == my:
            rows = l_loc[s - row0:e - row0]
            cand = torch.linalg.solve_triangular(
                rows[:, s:e].mT, z[s:e, None], upper=True)[:, 0]
            msg = torch.cat([cand, rows[:, :s].mT @ cand])
        else:
            msg = z.new_zeros(e)
        msg = comm.psum(msg, mesh, axis)
        parts.append(msg[:panel])
        z = torch.cat([z[:s] - msg[panel:], z[s:]])
    return torch.cat(parts[::-1])


def distributed_forward_solve_cols(l_sharded, b_sharded, mesh, *,
                                   axis: str = "data", panel: int = 128):
    """Solve ``L A = B`` with L and the (N, M) ``B`` row-sharded; ``A``
    comes back row-sharded (no rank holds a whole (N, M) array). One
    ``psum`` of the solved (panel, M) block per panel."""
    full_fp32()
    n = l_sharded.shape[-1]
    _check_rows(n, comm.axis_size(mesh, axis), panel)
    l_loc = local(l_sharded, mesh, axis)
    z = local(b_sharded, mesh, axis)     # the residual of own rows >= s
    row0, rows_per = _block(mesh, axis, n)
    hi = row0 + rows_per
    owner_of = rows_per // panel
    my = comm.axis_index(mesh, axis)
    own = []
    for p in range(n // panel):
        s, e = p * panel, (p + 1) * panel
        if p // owner_of == my:
            cand = torch.linalg.solve_triangular(
                l_loc[s - row0:e - row0, s:e], z[:panel], upper=False)
        else:
            cand = z.new_zeros((panel, z.shape[-1]))
        u_p = comm.psum(cand, mesh, axis)
        if p // owner_of == my:
            own.append(u_p)
        if e < hi:
            lo, r = max(row0, s), max(row0, e)
            z = z[r - lo:] - l_loc[r - row0:, s:e] @ u_p
    return sharded(torch.cat(own), mesh, axis)


def sharded_cross_gram(kernel, x, xs, mesh, *, axis: str = "data"):
    """``K(x, xs)`` row-sharded over the training points (each rank its
    rows, by the Gram kernel on the card): the distributed
    ``buildDistCov`` (KernelFunction.scala:94-109)."""
    x = as_locations(x)
    return sharded(kernel.gram(local(x, mesh, axis), as_locations(xs),
                               center_of=x), mesh, axis)


def _params_list(params):
    return (list(params), True) if isinstance(params, (list, tuple)) else (
        [params], False)


def logml_body(params, x_loc, y_rep, *, mesh, axis: str, n: int,
               nugget: float = 1e-3, panel: int = 128):
    """Exact GP logML with the data row-sharded over ``mesh[axis]``: the
    rank-local program of :func:`distributed_logml`
    (GaussianProcess.loglikelihood, GaussianProcess.scala:109-127). The
    locations are all-gathered (O(N D)), each rank builds its Gram rows
    K(x_loc, x) with the Gram kernel, then the panel Cholesky, the solve
    and the logdet run over the same axis. ``params`` may be a list of
    parameter trees: the chains of one mesh row, batched through the panel
    program (values ``(k,)``)."""
    plist, batched = _params_list(params)
    row0 = comm.axis_index(mesh, axis) * x_loc.shape[0]
    x_full = comm.all_gather(x_loc, mesh, axis)
    # centred on the whole set, as the whole Gram is: the same r2 zeros
    k_loc = [p.kernel.gram(x_loc, x_full, center_of=x_full) for p in plist]
    resid = [y_rep - p.mean(x_full) for p in plist]
    # a batch dimension only for a batch (cuBLAS's batched products of one
    # are slower than its plain ones)
    k_loc, resid = ((torch.stack(k_loc), torch.stack(resid)) if batched
                    else (k_loc[0], resid[0]))
    # the nugget on the global diagonal, which is this block's diagonal
    # at column offset row0
    k_loc = k_loc.diagonal_scatter(
        k_loc.diagonal(row0, dim1=-2, dim2=-1) + nugget, row0, dim1=-2,
        dim2=-1)
    cols = _chol_panels(k_loc, mesh=mesh, axis=axis, n=n, panel=panel)
    u = forward_solve_body(cols, resid, mesh=mesh, axis=axis, n=n,
                           panel=panel)
    return (-0.5 * torch.sum(u * u, dim=-1)
            - half_logdet_body(cols, mesh=mesh, axis=axis)
            - n * _HALF_LOG_2PI)


def _logml(params, x, y, mesh, axis, nugget, panel):
    x = as_locations(x)
    n = x.shape[0]
    _check(n, comm.axis_size(mesh, axis), panel)
    return logml_body(params, local(x, mesh, axis), y, mesh=mesh, axis=axis,
                      n=n, nugget=nugget, panel=panel)


def distributed_logml(params, x, y, mesh, *, axis: str = "data",
                      nugget: float = 1e-3, panel: int = 128):
    """Exact GP marginal log-likelihood with the Gram build, Cholesky and
    solves all sharded over ``mesh[axis]``; replicated. Differentiable in
    the parameters: autograd reaches the gradient of
    :func:`distributed_logml_value_and_grad` (first order only)."""
    from gpx_torch.models.gp import _scalar_vjp

    full_fp32()

    def value_and_grad(p):
        return distributed_logml_value_and_grad(
            p, x, y, mesh, axis=axis, nugget=nugget, panel=panel)

    def primal(p):
        with torch.no_grad():
            return _logml(p, x, y, mesh, axis, nugget, panel)

    return _scalar_vjp(value_and_grad, primal=primal)(params)


def distributed_logml_value_and_grad(params, x, y, mesh, *,
                                     axis: str = "data", nugget: float = 1e-3,
                                     panel: int = 128):
    """``(logML, d logML / d params)`` of :func:`distributed_logml`, the
    gradient a ``Parameters`` tree: autograd through the sharded panel
    program, whose backward pass runs the collectives' transposes
    (all-gather -> reduce-scatter, ``psum`` -> all-reduce) in the reverse
    of their forward order on every rank; then each leaf's partials summed
    over the axis and divided by its size (:mod:`~gpx_torch.parallel.comm`).
    No rank holds K or L whole. Replicated."""
    full_fp32()
    value, grads = comm.value_and_grads(
        lambda ps: _logml(unflatten(params, ps), x, y, mesh, axis, nugget,
                          panel),
        leaves(params), mesh, axis)
    return value, unflatten(params, grads)


def distributed_predict(params, x, y, xs, mesh, *, axis: str = "data",
                        nugget: float = 1e-6, panel: int = 128):
    """GP posterior at ``xs`` with every O(N^2) object row-sharded: the
    Gram, its factor, the cross-covariance and ``A = L^-1 K(x, xs)`` (no
    rank holds an (N, N) or a whole (N, M) array). Predict.fit
    (Predict.scala:57-94) as the distributed Cholesky, alpha by the forward
    and back solves, the mean by ``psum``'d partial products and the
    variance from the row-sharded column solve. Replicated."""
    from gpx_torch.models import gp
    from gpx_torch.parallel.sharded import sharded_gram

    x = as_locations(x)
    xs = as_locations(xs)
    k = sharded_gram(params.kernel, x, mesh, nugget=nugget, axes=(axis, None))
    l = distributed_cholesky(k, mesh, axis=axis, panel=panel)
    u = distributed_forward_solve(l, y - params.mean(x), mesh, axis=axis,
                                  panel=panel)
    alpha = distributed_back_solve(l, u, mesh, axis=axis, panel=panel)
    kxs = sharded_cross_gram(params.kernel, x, xs, mesh, axis=axis)
    a = local(distributed_forward_solve_cols(l, kxs, mesh, axis=axis,
                                             panel=panel))
    kxs = local(kxs)
    moments = comm.psum(torch.cat([kxs.T @ local(alpha, mesh, axis),
                                   torch.sum(a * a, dim=0)]), mesh, axis)
    m = xs.shape[0]
    mean = params.mean(xs) + moments[:m]
    var = torch.clamp_min(params.kernel.diag(xs, dtype=mean.dtype)
                          - moments[m:], 0.0)
    return gp.PosteriorSummary(x=xs, mean=mean, variance=var)
