"""The distributed streamed Gram matvec: the matrix-free path across ranks
— the port of ``gpx/parallel/dist_matvec.py``.

The row range of ``K = k(x, x) + diag`` is sharded over a mesh axis: each
rank forms its row block of ``K v`` with the ``cross_matvec`` kernel (K is
never stored anywhere), from ``x`` and ``v`` that every rank holds whole.
The output stays row-sharded; :func:`gathered_matvec` all-gathers it (N R
values a product) for the solvers, which take replicated vectors.

The White and nugget diagonal is split out (``split_noise``) and added to
each rank's own rows, so gradients flow through the noise variance and
D > 8 inputs keep the White term. ``method="xla"`` takes the plain
row-blocked torch route, differentiable in the kernel's hyperparameters,
for the gradient contraction.
"""

from __future__ import annotations

from gpx_torch.kernels import split_noise, unwrap_ard
from gpx_torch.models.gp_iterative import _GRAD_BLOCK_ENTRIES
from gpx_torch.ops.cuda_matvec import _cross_matvec_torch
from gpx_torch.ops.distance import as_locations
from gpx_torch.ops.matvec import cross_matvec
from gpx_torch.parallel import comm
from gpx_torch.parallel.dist_chol import sharded


def distributed_gram_matvec(kernel, x, mesh, *, axis: str = "data",
                            nugget: float = 0.0, method: str = "auto"):
    """``mv(v) = (k(x, x) + (noise + nugget) I) v`` with the row range
    sharded over ``mesh[axis]``: ``v`` ((N,) or (N, R)) whole on every rank
    in, a row-sharded ``DTensor`` out. ``method="xla"`` forces the
    differentiable plain route (for the gradient contraction); otherwise a
    float32 CUDA tensor goes to the ``cross_matvec`` kernel."""
    rows = _local_matvec(kernel, x, mesh, axis, nugget, method)
    return lambda v: sharded(rows(v), mesh, axis)


def _local_matvec(kernel, x, mesh, axis, nugget, method):
    """``v -> `` this rank's rows of ``(k(x, x) + (noise + nugget) I) v``."""
    x = as_locations(x)
    # ARD = isotropic base on scaled coordinates (keeps the kernel's route)
    kernel, x, _ = unwrap_ard(kernel, x)
    n = x.shape[0]
    d = comm.axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"N={n} must split over the {d}-device '{axis}' "
                         f"axis")
    row0 = comm.axis_index(mesh, axis) * (n // d)
    row1 = row0 + n // d
    smooth, noise_var = split_noise(kernel)
    diag = noise_var + nugget
    # distances are translation-invariant; centring keeps coordinate
    # rounding out of the float32 r2, as gram_matvec centres
    xc = x - x.mean(dim=0, keepdim=True).detach()
    x_loc = xc[row0:row1]
    block = max(1, min(2048, _GRAD_BLOCK_ENTRIES // n))

    def rows(v2):
        v_loc = v2[row0:row1]
        if smooth is None:
            return diag * v_loc
        if method == "xla":
            y_loc = _cross_matvec_torch(smooth, x_loc, xc, v2, block)
        else:
            y_loc = cross_matvec(smooth, x_loc, xc, v2)
        return y_loc + diag * v_loc

    def mv(v):
        squeeze = v.ndim == 1
        out = rows(v[:, None] if squeeze else v)
        return out[:, 0] if squeeze else out

    return mv


def gathered_matvec(kernel, x, mesh, *, axis: str = "data",
                    nugget: float = 0.0, method: str = "auto"):
    """:func:`distributed_gram_matvec` with its output all-gathered: a
    drop-in ``matvec`` for the solvers (CG, Lanczos, SLQ) and the gradient
    contractions, whose vectors are replicated."""
    rows = _local_matvec(kernel, x, mesh, axis, nugget, method)
    return lambda v: comm.all_gather(rows(v), mesh, axis)
