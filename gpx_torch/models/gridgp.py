"""Grid-structured GPs: exact inference with separable kernels on
Cartesian-product inputs — the port of ``gpx/models/gridgp.py``.

When the N inputs form a grid ``X = axes[0] x axes[1] x ...`` and the kernel
is separable, ``k(x, x') = prod_i k_i(x_i, x'_i)``, the Gram matrix is the
Kronecker product ``K_1 (x) K_2 (x) ...`` and exact inference needs only
per-axis eigendecompositions:

    K + s2 I = (prod_i Q_i) (prod_i L_i + s2 I) (prod_i Q_i)^T,

O(sum n_i^3) instead of O((prod n_i)^3); after the per-axis ``eigh`` every
step is a chain of per-axis contractions. On the card, in float32, the
per-axis Grams and the cross blocks come from the CUDA Gram kernel; the
``eigh``s are ``torch.linalg``'s with TF32 off. The logML's gradient holds
the eigenbases constant (no ``eigh`` VJP, which divides by eigenvalue
gaps): it is defined at repeated eigenvalues.

Incomplete grids: ``fit(mask=...)`` solves for the posterior mean by CG on
the mask-embedded Kronecker matvec (exact under masking; no ``eigh``).
:class:`CoregionAxis` makes one axis an output axis, ``B (x) K_time (x)
K_space + s2 I``. ``mesh=`` shards the lattice tensor's leading axis over
``mesh[mesh_axis]`` in the rotations (every rank of the axis calls with the
same arguments and gets the same result).
"""

from __future__ import annotations

import math
from functools import reduce

import torch

from gpx_torch import bijectors as bij
from gpx_torch._device import as_tensor, full_fp32
from gpx_torch._module import FieldModule
from gpx_torch.models import gp
from gpx_torch.models.gp_iterative import cg_solve
from gpx_torch.models.multioutput import (_held_basis_surrogate, _on,
                                          _staggered_w, _with_gradient)
from gpx_torch.ops import chol
from gpx_torch.ops.distance import as_locations
from gpx_torch.params import leaves


class GridParams(FieldModule):
    """Separable-kernel hyperparameters: one kernel per grid axis and a
    shared observation noise. ``k(x, x') = prod_i k_i(x_i, x'_i)``: the
    signal variance multiplies across axes, so fix ``h = 1`` on all but
    one."""

    _fields = ("kernels", "noise")

    def __init__(self, kernels, noise):
        super().__init__(kernels=tuple(kernels), noise=noise)

    @property
    def n_axes(self) -> int:
        return len(self.kernels)

    def bijectors(self) -> "GridParams":
        return GridParams(kernels=tuple(k.bijectors() for k in self.kernels),
                          noise=bij.positive)


def grid(kernels, noise: float = 0.1) -> GridParams:
    """Constructor from a list of per-axis kernels; the noise on the first
    kernel's device and in its type."""
    kernels = tuple(kernels)
    return GridParams(kernels=kernels, noise=_on(leaves(kernels[0])[0], noise))


class CoregionAxis(FieldModule):
    """Pseudo-kernel for an output axis of a grid model: its Gram is the
    coregionalization matrix ``B = W W^T + diag(kappa)`` indexed by the
    axis's coordinates, output ids (T, 1). As one of :class:`GridParams`'
    kernels it gives ``B (x) K_time (x) K_space + s2 I``. It is not a
    :class:`gpx_torch.kernels.Kernel`: its Gram never reaches the CUDA
    Gram kernel."""

    _fields = ("w", "kappa")

    def __init__(self, w, kappa):
        super().__init__(w=w, kappa=kappa)

    @property
    def n_outputs(self) -> int:
        return self.w.shape[0]

    def _b(self, dtype=None):
        b = self.w @ self.w.T + torch.diag(self.kappa)
        return b if dtype is None else b.to(dtype)

    @staticmethod
    def _ids(a, device):
        return torch.as_tensor(a).reshape(-1).to(device=device,
                                                 dtype=torch.int64)

    def gram(self, a, a2=None, *, nugget: float = 0.0, method: str = "auto"):
        b = self._b()
        i1 = self._ids(a, b.device)
        if a2 is None:
            out = b[i1][:, i1]
            if nugget:
                out = out + nugget * torch.eye(out.shape[0], dtype=out.dtype,
                                               device=out.device)
            return out
        return b[i1][:, self._ids(a2, b.device)]

    def diag(self, x, dtype=None):
        d = torch.diagonal(self._b(dtype))
        return d[self._ids(x, d.device)]

    def bijectors(self) -> "CoregionAxis":
        return CoregionAxis(w=bij.identity, kappa=bij.positive)


def coregion_axis(n_outputs: int, rank: int = 1, *, w=None, kappa=0.2,
                  device=None, dtype=None) -> CoregionAxis:
    """Constructor with ``multioutput.icm``'s staggered default ``W``, on
    ``device`` (default: the card)."""
    like = as_tensor(0.0, device=device, dtype=dtype)
    w = _staggered_w(n_outputs, rank, like) if w is None else _on(like, w)
    kappa = _on(like, kappa).broadcast_to((n_outputs,)).clone()
    return CoregionAxis(w=w, kappa=kappa)


def output_axis(n_outputs: int, *, device=None, dtype=None):
    """The grid-axis coordinates of a :class:`CoregionAxis`: output ids
    ``(T, 1)``."""
    like = as_tensor(0.0, device=device, dtype=dtype)
    return torch.arange(n_outputs, dtype=like.dtype,
                        device=like.device)[:, None]


def _check_axes(p: GridParams, axes):
    axes = [as_locations(a) for a in axes]
    if len(axes) != p.n_axes:
        raise ValueError(f"{p.n_axes} per-axis kernels but {len(axes)} grid "
                         f"axes")
    return axes


def grid_shape(axes):
    return tuple(a.shape[0] for a in [as_locations(a) for a in axes])


def grid_coords(axes):
    """The full (N, sum D_i) Cartesian-product locations, for comparing with
    dense paths; inference never builds them."""
    axes = [as_locations(a) for a in axes]
    idx = torch.meshgrid(*[torch.arange(a.shape[0], device=a.device)
                           for a in axes], indexing="ij")
    return torch.cat([a[i.reshape(-1)] for a, i in zip(axes, idx)], dim=1)


def _axis_contract(m, t, axis):
    """Contract the matrix ``m`` (r, n_axis) against axis ``axis`` of ``t``
    (trailing axes ride along): the per-axis step of every Kronecker
    identity here, in full float32 on the card."""
    return torch.movedim(torch.tensordot(m, t, dims=([1], [axis])), 0, axis)


def _shard0(t, mesh, mesh_axis):
    """This rank's block of a grid tensor's leading axis over
    ``mesh[mesh_axis]`` (``t`` itself without a mesh); the axis must divide
    over the ranks."""
    if mesh is None:
        return t
    from gpx_torch.parallel import comm

    d = comm.axis_size(mesh, mesh_axis)
    if t.shape[0] % d:
        raise ValueError(f"the leading grid axis ({t.shape[0]}) must divide "
                         f"over the {d}-rank '{mesh_axis}' axis")
    rows = t.shape[0] // d
    i = comm.axis_index(mesh, mesh_axis)
    return t[i * rows:(i + 1) * rows]


def _rotate(t, mats, mesh=None, mesh_axis: str = "data"):
    """``(prod_i M_i) vec(t)`` as a chain of per-axis contractions. With a
    mesh the leading axis is sharded: the contractions along the other axes
    are rank-local, and the axis-0 rotation is each rank's partial product
    with its columns of ``M_0`` and a reduce-scatter; the result is
    all-gathered (replicated)."""
    if mesh is None:
        for i, m in enumerate(mats):
            t = _axis_contract(m, t, i)
        return t
    from gpx_torch.parallel import comm

    t = _shard0(t, mesh, mesh_axis)
    rows = t.shape[0]
    i0 = comm.axis_index(mesh, mesh_axis) * rows
    for i, m in enumerate(mats):
        if i == 0:
            t = comm.reduce_scatter(
                _axis_contract(m[:, i0:i0 + rows], t, 0), mesh, mesh_axis)
        else:
            t = _axis_contract(m, t, i)
    return comm.all_gather(t, mesh, mesh_axis)


def _grams(p: GridParams, axes):
    return [k.gram(a) for k, a in zip(p.kernels, axes)]


def _eigs(p: GridParams, grams, nugget):
    """Per-axis ``eigh`` (TF32 off) of the per-axis Grams and the full
    eigenvalue tensor ``S = prod L_i + noise + nugget``; the small negative
    float32 eigenvalues are clamped at 0."""
    full_fp32()
    qs, lams = [], []
    for g in grams:
        lam, q = chol.eigh(g)
        qs.append(q)
        lams.append(torch.clamp_min(lam, 0.0))
    s = reduce(lambda acc, lam: acc[..., None] * lam, lams[1:], lams[0])
    return qs, lams, s + p.noise + nugget


def _check_y(Y, shape, device):
    Y = as_tensor(Y, device=device)
    n = int(math.prod(shape))
    if tuple(Y.shape) == shape:
        return Y
    if Y.ndim == 1 and Y.shape[0] == n:
        return Y.reshape(shape)
    raise ValueError(f"Y has shape {tuple(Y.shape)}; expected the grid shape "
                     f"{shape} or a flat ({n},) vector (C order over the "
                     f"axes)")


def log_marginal_likelihood(p: GridParams, axes, Y, *,
                            nugget: float = gp.LOGML_NUGGET, mesh=None,
                            mesh_axis: str = "data"):
    """Exact ``log N(vec Y | 0, prod_i K_i + (noise + nugget) I)`` through
    the Kronecker eigen-identity; ``Y`` in grid shape or flat (C order).
    ``mesh=`` shards the rotations' leading lattice axis (n_1 must divide
    by the axis size; put the long axis first)."""
    full_fp32()
    axes = _check_axes(p, axes)
    shape = tuple(a.shape[0] for a in axes)
    Y = _check_y(Y, shape, axes[0].device)
    grams = _grams(p, axes)
    with torch.no_grad():
        qs, lams, s = _eigs(p, grams, nugget)
        yt = _rotate(Y, [q.T for q in qs], mesh, mesh_axis)
        quad = torch.sum(yt * yt / s)
        logdet = torch.sum(torch.log(s))
        value = -0.5 * (quad + logdet
                        + math.prod(shape) * math.log(2.0 * math.pi))
    live = (*grams, p.noise, Y)
    if not (torch.is_grad_enabled() and any(v.requires_grad for v in live)):
        return value
    # the gradient with the eigenbases held constant, as the Kronecker
    # ICM's: a = K^-1 vec Y in grid shape
    with torch.no_grad():
        alpha = _rotate(yt / s, qs, mesh, mesh_axis)
    return _with_gradient(value, _held_basis_surrogate(
        grams, qs, lams, s, alpha, p.noise, Y))


def draw(key, p: GridParams, axes, *, shape=(), include_noise: bool = True,
         nugget: float = 1e-8):
    """Joint prior draw over the lattice, ``(*shape, n_1, ..., n_k)``, by
    the per-axis eigen square root ``f = (prod Q_i L_i^(1/2)) z``; ``z`` and
    then the noise are drawn from the ``torch.Generator`` ``key``."""
    axes = _check_axes(p, axes)
    gshape = tuple(a.shape[0] for a in axes)
    qs, lams, _ = _eigs(p, _grams(p, axes), nugget=0.0)
    roots = [q * torch.sqrt(lam + nugget)[None, :] for q, lam in zip(qs, lams)]
    like = roots[0]

    def normal(size):
        return torch.randn(size, generator=key, dtype=like.dtype,
                           device=key.device).to(like.device)

    z = normal((*shape, *gshape))
    batch = z.reshape((-1,) + gshape)
    f = torch.stack([_rotate(zb, roots) for zb in batch]).reshape(z.shape)
    if include_noise:
        f = f + torch.sqrt(p.noise) * normal(f.shape)
    return f


def _split_xs(p, axes, xs):
    """Split full-dimension test locations into per-axis coordinate blocks
    (column order = axis order, as :func:`grid_coords`)."""
    dims = [a.shape[1] for a in axes]
    if xs.shape[1] != sum(dims):
        raise ValueError(f"test locations have D={xs.shape[1]}; the grid "
                         f"axes concatenate to D={sum(dims)}")
    out, off = [], 0
    for d in dims:
        out.append(xs[:, off:off + d])
        off += d
    return out


def _mean_chain(mats, t):
    """``mean[m] = sum_j prod_i mats_i[m, j_i] t[j]``: a per-test-point
    factorized row against a grid tensor, one batched product per axis."""
    out = torch.einsum("mi,i...->m...", mats[0], t)
    for c in mats[1:]:
        out = torch.einsum("mi,mi...->m...", c, out)
    return out


def _cross(p, axes, xs):
    xs = as_locations(as_tensor(xs, device=axes[0].device,
                                dtype=axes[0].dtype))
    blocks = _split_xs(p, axes, xs)
    return xs, blocks, [k.gram(b, a) for k, b, a in
                        zip(p.kernels, blocks, axes)]   # (M, n_i) each


def fit(p: GridParams, axes, Y, xs, *, nugget: float = gp.PREDICT_NUGGET,
        variance: bool = True, mask=None, cg_tol: float = 1e-6,
        cg_max_iters: int = 1000, mesh=None, mesh_axis: str = "data"):
    """Posterior at test locations ``xs`` (M, sum D_i) through the
    Kronecker eigen-identity, a :class:`gpx_torch.models.gp.PosteriorSummary`
    whose variance includes the observation noise.

    ``mask`` (grid-shaped boolean, True = observed): the posterior mean on
    an incomplete lattice by CG on the mask-embedded Kronecker matvec; no
    variance then (an empty one, as ``variance=False``). ``mesh=`` shards
    the rotations' leading lattice axis."""
    full_fp32()
    axes = _check_axes(p, axes)
    shape = tuple(a.shape[0] for a in axes)
    Y = _check_y(Y, shape, axes[0].device)
    xs, xs_blocks, cross = _cross(p, axes, xs)
    if mask is not None:
        alpha = _masked_alpha(p, axes, Y, mask, nugget, cg_tol, cg_max_iters)
        mean = _mean_chain(cross, alpha)
        return gp.PosteriorSummary(x=xs, mean=mean,
                                   variance=mean.new_zeros((0,)))
    qs, _, s = _eigs(p, _grams(p, axes), nugget)
    yt = _rotate(Y, [q.T for q in qs], mesh, mesh_axis)
    alpha = _rotate(yt / s, qs, mesh, mesh_axis)       # K^-1 vec Y, gridded
    mean = _mean_chain(cross, alpha)
    if not variance:
        return gp.PosteriorSummary(x=xs, mean=mean,
                                   variance=mean.new_zeros((0,)))
    # rotated cross rows factorize per axis, (prod Q^T) k_m = prod (Q_i^T
    # k_m,i): the reduction is the same chain on elementwise squares
    a_sq = [torch.square(c @ q) for c, q in zip(cross, qs)]
    red = _mean_chain(a_sq, 1.0 / s)
    prior = reduce(lambda acc, kb: acc * kb[0].diag(kb[1], dtype=mean.dtype),
                   zip(p.kernels, xs_blocks), torch.ones_like(mean))
    var = torch.clamp_min(prior - red, 0.0) + p.noise
    return gp.PosteriorSummary(x=xs, mean=mean, variance=var)


def posterior_draw(key, p: GridParams, axes, Y, xs, *,
                   nugget: float = gp.PREDICT_NUGGET, jitter: float = 1e-8,
                   shape=(), include_noise: bool = True):
    """Joint draw from the grid posterior at ``xs``, ``(*shape, M)``: with
    per-axis rotated cross factors ``P_i = C_i Q_i`` the reduction ``A
    A^T[m, m'] = sum_j prod_i P_i[m, j_i] P_i[m', j_i] / s_j`` is the same
    Kronecker chain on pairwise products, O(M^2 sum n_i). ``key`` is a
    ``torch.Generator``."""
    full_fp32()
    axes = _check_axes(p, axes)
    gshape = tuple(a.shape[0] for a in axes)
    Y = _check_y(Y, gshape, axes[0].device)
    xs, xs_blocks, cross = _cross(p, axes, xs)
    m = xs.shape[0]
    qs, _, s = _eigs(p, _grams(p, axes), nugget)
    alpha = _rotate(_rotate(Y, [q.T for q in qs]) / s, qs)
    mean = _mean_chain(cross, alpha)                          # (M,)
    pair = [torch.einsum("mi,ri->mri", pm, pm).reshape(m * m, -1)
            for pm in (c @ q for c, q in zip(cross, qs))]
    red = _mean_chain(pair, 1.0 / s).reshape(m, m)            # A A^T
    kss = reduce(lambda acc, kb: acc * kb[0].gram(kb[1]),
                 zip(p.kernels, xs_blocks),
                 torch.ones((m, m), dtype=mean.dtype, device=mean.device))
    cov = kss - red
    eye = torch.eye(m, dtype=cov.dtype, device=cov.device)
    if include_noise:
        cov = cov + p.noise * eye
    lp = chol.cholesky(cov + jitter * eye)
    z = torch.randn((*shape, m), generator=key, dtype=lp.dtype,
                    device=key.device).to(lp.device)
    return mean + z @ lp.T


def kron_matvec(p: GridParams, axes, *, nugget: float = 0.0):
    """``mv(V) = (prod_i K_i + (noise + nugget) I) vec(V)`` on grid-shaped
    tensors (trailing axes ride along): O(N sum n_i) per apply, no
    eigendecomposition."""
    full_fp32()
    grams = _grams(p, _check_axes(p, axes))
    d = p.noise + nugget

    def mv(V):
        out = V
        for i, g in enumerate(grams):
            out = _axis_contract(g, out, i)
        return out + d * V

    return mv


def _masked_alpha(p, axes, Y, mask, nugget, cg_tol, cg_max_iters):
    """``K^-1 y`` on the observed entries by CG on the mask-embedded
    operator (the identity off the mask), zero elsewhere."""
    shape = tuple(a.shape[0] for a in axes)
    mask = torch.as_tensor(mask, dtype=torch.bool,
                           device=Y.device).reshape(shape)
    y0 = torch.where(mask, torch.where(torch.isfinite(Y), Y, 0.0), 0.0)
    mv = kron_matvec(p, axes, nugget=nugget)
    mcol = mask[..., None]

    def embedded(v2):                      # (N, R): CG's column block
        v = v2.reshape(*shape, -1)
        out = torch.where(mcol, mv(torch.where(mcol, v, 0.0)), v)
        return out.reshape(v2.shape)

    # the convergence flag is not returned (the summary keeps gp.fit's
    # shape); a stiff operator needs a larger cg_max_iters
    sol, _, _ = cg_solve(embedded, y0.reshape(-1), tol=cg_tol,
                         max_iters=cg_max_iters)
    return torch.where(mask, sol.reshape(shape), 0.0)


def optimize(template: GridParams, axes, Y, *, log_prior=None, **kwargs):
    """Type-II MLE / MAP over every per-axis hyperparameter and the noise,
    through :func:`gpx_torch.models.optimize.optimize_log_density`."""
    from gpx_torch.models.optimize import optimize_log_density

    axes_c = _check_axes(template, axes)
    Y = _check_y(Y, tuple(a.shape[0] for a in axes_c), axes_c[0].device)

    def log_density(p):
        val = log_marginal_likelihood(p, axes_c, Y)
        return val if log_prior is None else val + log_prior(p)

    return optimize_log_density(template, log_density, **kwargs)


def sample_mh(key, axes, Y, template: GridParams, log_prior, n_samples: int,
              **kwargs):
    """Random-walk MH over the separable hyperparameters against the
    Kronecker logML."""
    from gpx_torch.infer.mcmc import sample_mh_log_density

    axes_c = _check_axes(template, axes)
    Y = _check_y(Y, tuple(a.shape[0] for a in axes_c), axes_c[0].device)

    def log_density(p):
        return log_marginal_likelihood(p, axes_c, Y) + log_prior(p)

    return sample_mh_log_density(key, template, log_density, n_samples,
                                 **kwargs)
