"""Matrix-free GP inference — the port of ``gpx/models/gp_iterative.py``:
conjugate-gradient solves and stochastic Lanczos quadrature (SLQ) for the
log-determinant, with every product a streamed Gram matvec
(:mod:`gpx_torch.ops.matvec`), so memory is O(N) where the dense paths need
O(N^2).

* ``alpha = K^-1 (y - m)`` by (preconditioned) conjugate gradients;
* ``log det K`` by SLQ, plain (Lanczos) or preconditioned (the Lanczos
  tridiagonals recovered from PCG, probes drawn from N(0, P));
* the hyperparameter gradient by the Hutchinson estimator with the probe
  solves of the same CG batch, contracted by autograd through the plain
  row-blocked matvec.

Loops that JAX writes as ``lax.while_loop``/``scan`` are Python loops here;
CG reads its residual norms on the host once per iteration. Probes are
drawn from a ``torch.Generator``: the draws differ from JAX's, so the
private cores take the base noise and the tests feed them gpx's own.
``mesh=`` row-shards every Gram matvec over ``mesh[mesh_axis]``
(:mod:`gpx_torch.parallel.dist_matvec`): every rank of the axis calls the
entry point with the same arguments and gets the same result.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gpx_torch._device import as_tensor, full_fp32
from gpx_torch.kernels import has_white, split_noise
from gpx_torch.models.gp import LOGML_NUGGET, PREDICT_NUGGET, _grads_or_zeros
from gpx_torch.ops.cuda_matvec import _gram_matvec_torch
from gpx_torch.ops.distance import as_locations, check_xy, sq_distances
from gpx_torch.ops.matvec import cross_matvec, gram_matvec
from gpx_torch.params import Parameters, leaves, unflatten

_TINY = 1e-30
# rows per block of the gradient contraction's plain matvec: gpx's 2048,
# fewer once a block would pass 2^27 entries (512 MiB in float32), so its
# autograd temporaries stay a few GiB at N = 131,072
_GRAD_BLOCK_ENTRIES = 1 << 27


def _matvec(kernel, x, nugget, mesh, mesh_axis, method="auto"):
    """``v -> (K + nugget I) v`` on replicated vectors: one device's
    streamed matvec, or with a mesh the row-sharded one, gathered."""
    if mesh is None:
        if method == "xla":
            block = max(1, min(2048, _GRAD_BLOCK_ENTRIES // x.shape[0]))
            return lambda v: _gram_matvec_torch(kernel, x, v, nugget, block)
        return lambda v: gram_matvec(kernel, x, v, nugget=nugget)
    from gpx_torch.parallel.dist_matvec import gathered_matvec

    return gathered_matvec(kernel, x, mesh, axis=mesh_axis, nugget=nugget,
                           method=method)


def _leaf_grads(fn, tensors, mesh, mesh_axis):
    """``d fn / d tensors`` of the scalar ``fn(tensors)``; with a mesh, of
    the replicated scalar whose matvecs are gathered over it."""
    if mesh is None:
        ls = [t.detach().requires_grad_() for t in tensors]
        with torch.enable_grad():
            return _grads_or_zeros(fn(ls), ls)
    from gpx_torch.parallel import comm

    return comm.value_and_grads(fn, tensors, mesh, mesh_axis)[1]


def _m_inv(precond):
    if precond is None:
        return lambda v: v
    return precond.apply if hasattr(precond, "apply") else precond


def cg_solve(matvec, b, *, tol: float = 1e-6, max_iters: int = 1000, x0=None,
             precond=None):
    """(Preconditioned) conjugate gradients for SPD systems, for (N,) or
    (N, R) right-hand sides; returns ``(x, iterations, converged)``.

    The stop test is absolute: every column's ``sum(r^2) <= tol^2``.
    Converged columns are frozen (iterating them on underflows their
    residual to 0 and ``beta = 0/0`` poisons the batch), and so is a column
    that breaks down (non-positive curvature or ``r^T M^-1 r <= 0``), which
    stays finite and unconverged. ``precond``: a callable or an object
    with ``.apply`` giving an approximate ``K^-1``."""
    m_inv = _m_inv(precond)
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    x = torch.zeros_like(b2) if x0 is None else (x0[:, None] if squeeze else x0)
    r = b2 - matvec(x)
    z = m_inv(r)
    p = z
    rz = torch.sum(r * z, dim=0)
    rs = torch.sum(r * r, dim=0)
    tol2 = tol * tol
    iters = 0
    # one host read of the residual norms per iteration
    while iters < max_iters and float(torch.max(rs)) > tol2:
        active = rs > tol2
        ap = matvec(p)
        denom = torch.sum(p * ap, dim=0)
        ok = active & (denom > 0.0) & torch.isfinite(denom) & (rz > 0.0)
        alpha = torch.where(ok, rz / torch.where(ok, denom, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_inv(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(ok, rz_new / torch.clamp_min(rz, _TINY), 0.0)
        p = torch.where(ok, z + beta * p, p)
        rz = rz_new
        rs = torch.sum(r * r, dim=0)
        iters += 1
    converged = bool(torch.max(rs) <= tol2)
    return (x[:, 0] if squeeze else x), iters, converged


def pivoted_cholesky(kernel, x, rank: int, *, method: str = "auto"):
    """Rank-``rank`` pivoted (greedy) Cholesky of the kernel's Gram:
    ``K ~= L_r L_r^T`` from ``rank`` adaptively chosen kernel columns, in
    O(N rank^2) time and O(N rank) memory; K never forms.

    Each step pivots on the largest residual diagonal entry, evaluates that
    kernel column (with an exact-zero self-distance at the pivot, so White
    terms count there), and subtracts the columns so far. Once the residual
    diagonal is below ``1e-7 max(diag)`` the remaining columns are zero.
    The pivot stays on the device: no step waits on the host. ``method`` is
    accepted as in the JAX package, which does not read it either."""
    full_fp32()
    x = as_locations(x)
    n = x.shape[0]
    dtype = x.dtype
    for leaf in leaves(kernel):
        dtype = torch.promote_types(dtype, leaf.dtype)
    diag = kernel.diag(x, dtype=dtype)
    exact = x.shape[-1] > 8 and has_white(kernel)
    floor = 1e-7 * torch.max(diag)

    l_r = torch.zeros((n, rank), dtype=dtype, device=x.device)
    d = diag.clone()
    for i in range(rank):
        pivot = torch.argmax(d).reshape(1)
        xp = x.index_select(0, pivot)                         # (1, D)
        r2 = sq_distances(x, xp, exact=exact).index_fill(0, pivot, 0.0)
        # evaluate_xx, not evaluate_r2: non-stationary kernels need the
        # coordinates
        k_col = kernel.evaluate_xx(x, xp, r2)[:, 0]
        resid = k_col - l_r @ l_r.index_select(0, pivot)[0]
        d_pivot = d.index_select(0, pivot)[0]
        # a zero column once the pivots are exhausted (dividing by a
        # cancelled-to-zero residual gives inf or NaN in float32)
        col = torch.where(d_pivot > floor,
                          resid / torch.sqrt(torch.clamp_min(d_pivot, floor)),
                          torch.zeros_like(resid))
        l_r[:, i] = col
        d = torch.clamp_min(d - col * col, 0.0).index_fill(0, pivot, 0.0)
    return l_r


def _rademacher(key, shape, dtype, device):
    u = torch.randint(0, 2, shape, generator=key, device=key.device)
    return (u * 2 - 1).to(device=device, dtype=dtype)


def _normal(key, shape, dtype, device):
    return torch.randn(shape, generator=key, device=key.device,
                       dtype=dtype).to(device)


class WoodburyPreconditioner(NamedTuple):
    """``P = L_r L_r^T + noise I`` held in its eigenbasis: ``P = W (lam +
    noise) W^T + noise (I - W W^T)`` with ``W`` orthonormal (n, r).

    The JAX package measured the textbook Woodbury solve to make ``P^-1``
    asymmetric enough in float32 that PCG diverged at n = 32k; in this
    form ``P^-1`` is an elementwise scale in an orthonormal basis, symmetric
    to rounding. ``apply`` is ``P^-1``, ``logdet`` is ``log det P`` (exact),
    and ``sample`` draws probes through the exact square root ``W sqrt(lam
    + noise) W^T + sqrt(noise) (I - W W^T)``."""

    w: torch.Tensor        # (n, r) orthonormal
    lam: torch.Tensor      # (r,) eigenvalues of L_r L_r^T, >= 0
    noise: torch.Tensor
    n: int

    def apply(self, v):
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        scale = (self.lam / (self.lam + self.noise)).to(v2.dtype)
        w = self.w.to(v2.dtype)
        out = (v2 - w @ (scale[:, None] * (w.T @ v2))) / self.noise.to(v2.dtype)
        return out[:, 0] if squeeze else out

    @property
    def logdet(self):
        rank = self.lam.shape[0]
        return (torch.sum(torch.log(self.lam + self.noise))
                + (self.n - rank) * torch.log(self.noise))

    def root(self, u):
        """``P^(1/2) u`` for a base block ``u`` (n, s)."""
        gain = torch.sqrt(self.lam + self.noise) - torch.sqrt(self.noise)
        return self.w @ (gain[:, None] * (self.w.T @ u)) + torch.sqrt(self.noise) * u

    def sample(self, key, n_probes: int, base: str = "normal"):
        """Probes ``z = P^(1/2) u`` from a ``torch.Generator``.
        ``base="normal"`` gives z ~ N(0, P), the SLQ probes;
        ``base="rademacher"`` keeps ``E[z z^T] = P`` with Rademacher ``u``,
        the gradient probes (the JAX package measured 30x the White
        gradient's variance with Gaussian P-probes)."""
        draw = _rademacher if base == "rademacher" else _normal
        return self.root(draw(key, (self.n, n_probes), self.w.dtype,
                              self.w.device))


def pivoted_cholesky_preconditioner(kernel, x, rank: int, noise):
    """A :class:`WoodburyPreconditioner` for ``K ~= L_r L_r^T + noise I``;
    ``noise`` should be K's additive diagonal (White variance + nugget).
    QR and ``eigh`` run with TF32 off: the JAX package measured a W that
    loses orthonormality at the TPU's default precision to break PCG."""
    l_r = pivoted_cholesky(kernel, x, rank)
    noise = torch.as_tensor(noise, dtype=l_r.dtype, device=l_r.device)
    q, r_mat = torch.linalg.qr(l_r)
    lam, u = torch.linalg.eigh(r_mat @ r_mat.T)
    return WoodburyPreconditioner(w=q @ u, lam=torch.clamp_min(lam, 0.0),
                                  noise=noise, n=l_r.shape[0])


def lanczos(matvec, z, m: int):
    """``m`` Lanczos steps from the start vector ``z`` (n,), or from each
    column of ``z`` (n, s) at once through one matvec per step (the same
    arithmetic column by column). Returns the tridiagonal's ``alphas``
    (m,) and ``betas`` (m-1,), or (m, s) and (m-1, s). No
    reorthogonalization."""
    squeeze = z.ndim == 1
    z2 = z[:, None] if squeeze else z
    q = z2 / torch.linalg.vector_norm(z2, dim=0)
    q_prev = torch.zeros_like(q)
    beta_prev = torch.zeros(q.shape[1], dtype=q.dtype, device=q.device)
    alphas, betas = [], []
    for _ in range(m):
        w = matvec(q) - beta_prev * q_prev
        alpha = torch.sum(w * q, dim=0)
        w = w - alpha * q
        beta = torch.linalg.vector_norm(w, dim=0)
        q_prev, q = q, torch.where(beta > 1e-12, w / torch.clamp_min(beta, 1e-12), w)
        beta_prev = beta
        alphas.append(alpha)
        betas.append(beta)
    alphas, betas = torch.stack(alphas), torch.stack(betas)[:-1]
    return (alphas[:, 0], betas[:, 0]) if squeeze else (alphas, betas)


def _quadrature(t_diag, t_off):
    """``sum_k w_k log(theta_k)`` of each column's tridiagonal (m, s) and
    (m-1, s): Gauss quadrature weights from the first eigenvector row."""
    t = torch.diag_embed(t_diag.T) + torch.diag_embed(t_off.T, 1) \
        + torch.diag_embed(t_off.T, -1)
    theta, vecs = torch.linalg.eigh(t)
    theta = torch.clamp_min(theta, 1e-12)
    return torch.sum(vecs[:, 0, :] ** 2 * torch.log(theta), dim=-1)


def _slq_logdet(matvec, z, m: int):
    """Plain SLQ from Rademacher probes ``z`` (n, s): ``n`` times the mean
    quadrature (``||z||^2 = n``)."""
    alphas, betas = lanczos(matvec, z, m)
    return torch.mean(_quadrature(alphas, betas)) * z.shape[0]


def slq_logdet(matvec, n: int, key, *, n_probes: int = 16, m: int = 32,
               dtype=torch.float32):
    """Stochastic Lanczos quadrature estimate of ``log det K`` with
    ``n_probes`` Rademacher probes from the generator ``key``, on its
    device."""
    return _slq_logdet(matvec, _rademacher(key, (n, n_probes), dtype, key.device),
                       m)


def _pcg_tridiag(matvec, z, m: int, precond):
    """``m`` PCG iterations on ``K x = z``, returning the Lanczos
    tridiagonals of ``P^-1/2 K P^-1/2`` recovered from the step and
    direction coefficients: ``T_jj = 1/a_j + b_(j-1)/a_(j-1)``,
    ``T_(j,j+1) = sqrt(b_j)/a_j``, as (m, R) and (m-1, R). A column that
    converges or breaks down is frozen for good (its r, p and rz stay as
    they were) and its trailing entries extend with (1, 0), a
    log-eigenvalue contribution of zero."""
    m_inv = _m_inv(precond)
    r = z
    p = m_inv(r)
    rz = torch.sum(r * p, dim=0)
    a_prev = torch.ones_like(rz)
    b_prev = torch.zeros_like(rz)
    t_diags, t_offs = [], []
    for _ in range(m):
        ap = matvec(p)
        denom = torch.sum(p * ap, dim=0)
        ok = (rz > _TINY) & (denom > 0.0) & torch.isfinite(denom)
        a = torch.where(ok, rz / torch.where(ok, denom, 1.0), 1.0)
        r_new = torch.where(ok, r - a * ap, r)
        z_new = m_inv(r_new)
        rz_new = torch.where(ok, torch.sum(r_new * z_new, dim=0), rz)
        b = torch.where(ok, rz_new / torch.clamp_min(rz, _TINY), 0.0)
        p = torch.where(ok, z_new + b * p, p)
        t_diags.append(torch.where(ok, 1.0 / a + b_prev / a_prev, 1.0))
        t_offs.append(torch.where(ok, torch.sqrt(torch.clamp_min(b, 0.0)) / a, 0.0))
        r, rz, a_prev, b_prev = r_new, rz_new, a, b
    return torch.stack(t_diags), torch.stack(t_offs)[:-1]


def _slq_logdet_preconditioned(matvec, precond, z, m: int):
    """Preconditioned SLQ from probes ``z = P^(1/2) u`` (n, s): ``logdet P``
    plus the mean of each probe's quadrature weighted by its own ``||u||^2
    = z^T P^-1 z`` (the JAX package measured the expectation n in its place
    to re-inject the variance: 4.5 against 0.5 absolute at n = 400)."""
    weights = torch.sum(z * precond.apply(z), dim=0)
    t_diags, t_offs = _pcg_tridiag(matvec, z, m, precond)
    return precond.logdet + torch.mean(weights * _quadrature(t_diags, t_offs))


def slq_logdet_preconditioned(matvec, precond: WoodburyPreconditioner, key, *,
                              n_probes: int = 16, m: int = 32):
    """``logdet K = logdet P + E_u[u^T log(P^-1/2 K P^-1/2) u]`` with probes
    ``z = P^(1/2) u``, ``u ~ N(0, I)`` from the generator ``key``, and the
    quadrature from ``m`` PCG iterations (:func:`_pcg_tridiag`). Since
    ``P^-1 K ~= I`` the stochastic part is small: the variance reduction
    that makes SLQ usable at cond(K) ~ 1e5."""
    return _slq_logdet_preconditioned(matvec, precond,
                                      precond.sample(key, n_probes), m)


def _preconditioner(kernel, x, rank: int, nugget: float):
    """The pivoted-Cholesky preconditioner of the kernel's smooth part with
    its White terms and the nugget as the Woodbury diagonal (a mismatched
    noise floor makes ``P^-1 K`` worse conditioned than K, measured by the
    JAX package on its chip); ``None`` for ``rank == 0`` or a White-only
    kernel."""
    if rank <= 0:
        return None
    smooth, noise_var = split_noise(kernel)
    if smooth is None:
        return None
    return pivoted_cholesky_preconditioner(smooth, x, rank,
                                           noise=noise_var + nugget + 1e-8)


class IterativePosterior(NamedTuple):
    x: torch.Tensor
    mean: torch.Tensor
    variance: torch.Tensor     # empty (0,) tensor when variance="none"
    cg_iters: int
    cg_converged: bool


def fit_iterative(params: Parameters, x, y, xs, *,
                  nugget: float = PREDICT_NUGGET, cg_tol: float = 1e-5,
                  cg_max_iters: int = 1000, precond_rank: int = 0,
                  variance: str = "exact", variance_block: int = 256,
                  mesh=None, mesh_axis: str = "data") -> IterativePosterior:
    """Matrix-free GP posterior at ``xs`` (GPML Alg. 2.1 without forming
    K(x, x)): memory O(N (D + block)).

    * mean: one (preconditioned) CG solve for ``alpha``, then the streamed
      cross product ``K(xs, x) alpha``;
    * variance (``"exact"``): per block of ``variance_block`` test points,
      batched CG on the cross-covariance columns, ``var = k_ss -
      diag(K(S, x) K^-1 K(x, S))``; ``"none"`` skips it.

    ``xs`` takes ``x``'s device and type. ``mesh=`` row-shards every Gram
    matvec of the solves over ``mesh[mesh_axis]``."""
    if variance not in ("exact", "none"):
        raise ValueError(f"unknown variance mode: {variance}")
    full_fp32()
    x, y = check_xy(x, y)
    xs = as_locations(as_tensor(xs, device=x.device, dtype=x.dtype))
    m = xs.shape[0]
    kernel = params.kernel
    matvec = _matvec(kernel, x, nugget, mesh, mesh_axis)
    precond = _preconditioner(kernel, x, precond_rank, nugget)
    alpha, cg_iters, cg_converged = cg_solve(
        matvec, y - params.mean(x), tol=cg_tol, max_iters=cg_max_iters,
        precond=precond)
    mean = params.mean(xs) + cross_matvec(kernel, xs, x, alpha)
    if variance == "none":
        return IterativePosterior(xs, mean, mean.new_zeros((0,)), cg_iters,
                                  cg_converged)

    kss = kernel.diag(xs, dtype=mean.dtype)
    # whole blocks, the last padded with points at the origin, as gpx
    xs_p = F.pad(xs, (0, 0, 0, (-m) % variance_block))
    quads = []
    for b0 in range(0, xs_p.shape[0], variance_block):
        ks = kernel.gram(x, xs_p[b0:b0 + variance_block])   # K(x, S_b)
        sol, _, ok = cg_solve(matvec, ks, tol=cg_tol, max_iters=cg_max_iters,
                              precond=precond)
        quads.append(torch.sum(ks * sol, dim=0))
        cg_converged = cg_converged and ok
    var = torch.clamp_min(kss - torch.cat(quads)[:m], 0.0)
    return IterativePosterior(xs, mean, var, cg_iters, cg_converged)


class IterativeLogML(NamedTuple):
    value: torch.Tensor
    grads: Parameters
    cg_iters: int
    cg_converged: bool     # False: raise cg_max_iters or recondition


def logml_value_and_grad_iterative(
        params: Parameters, x, y, key, *, nugget: float = LOGML_NUGGET,
        n_probes: int = 16, lanczos_iters: int = 32, cg_tol: float = 1e-5,
        cg_max_iters: int = 1000, precond_rank: int = 0, mesh=None,
        mesh_axis: str = "data") -> IterativeLogML:
    """Matrix-free logML value and hyperparameter-gradient estimate.

    The quadratic term and its gradient are CG-exact up to ``cg_tol``; the
    logdet and its gradient are SLQ and Hutchinson estimates over
    ``n_probes`` probes. ``key`` is a ``torch.Generator`` (on any device):
    it draws the gradient probes' Rademacher base, then the SLQ base
    (Normal with a preconditioner, else Rademacher). ``precond_rank > 0``
    preconditions every solve with the pivoted Cholesky of the kernel's
    smooth part. Memory is O(N (D + probes)). ``mesh=`` runs every matvec
    (CG, Lanczos and the gradient contraction) with its row range sharded
    over ``mesh[mesh_axis]``; probes, vectors and the preconditioner stay
    replicated."""
    x, y = check_xy(x, y)
    n = x.shape[0]
    probe_noise = _rademacher(key, (n, n_probes), y.dtype, x.device)
    draw = _normal if precond_rank > 0 else _rademacher
    slq_noise = draw(key, (n, n_probes), y.dtype, x.device)
    return _logml_value_and_grad_iterative(
        params, x, y, probe_noise=probe_noise, slq_noise=slq_noise,
        nugget=nugget, lanczos_iters=lanczos_iters, cg_tol=cg_tol,
        cg_max_iters=cg_max_iters, precond_rank=precond_rank, mesh=mesh,
        mesh_axis=mesh_axis)


def _logml_value_and_grad_iterative(params: Parameters, x, y, *, probe_noise,
                                    slq_noise, nugget: float = LOGML_NUGGET,
                                    lanczos_iters: int = 32,
                                    cg_tol: float = 1e-5,
                                    cg_max_iters: int = 1000,
                                    precond_rank: int = 0, mesh=None,
                                    mesh_axis: str = "data") -> IterativeLogML:
    """The iterative logML on given base noise, both (n, s): Rademacher
    ``probe_noise`` for the gradient probes (taken through ``P^(1/2)`` with
    a preconditioner), and ``slq_noise``, the SLQ probes (Rademacher
    without a preconditioner, else the Normal base of ``P^(1/2) u``)."""
    full_fp32()
    x, y = check_xy(x, y)
    n = x.shape[0]
    kernel = params.kernel
    matvec = _matvec(kernel, x, nugget, mesh, mesh_axis)
    precond = _preconditioner(kernel, x, precond_rank, nugget)
    ms = [t.detach().requires_grad_() for t in leaves(params.mean)]
    with torch.enable_grad():
        mean_val = unflatten(params.mean, ms)(x)
    r = y - mean_val.detach()

    # alpha = K^-1 r and the probe solves K^-1 z in one CG batch; with a
    # preconditioner the probes are P^(1/2) u and the Hutchinson weights
    # P^-1 z (E[z^T K^-1 G P^-1 z] = tr(K^-1 G) still, at lower variance)
    probes = probe_noise.to(r.dtype)
    if precond is not None:
        probes = precond.root(probes).to(r.dtype)
        probe_weights = precond.apply(probes)
    else:
        probe_weights = probes
    solves, cg_iters, cg_converged = cg_solve(
        matvec, torch.cat([r[:, None], probes], dim=1), tol=cg_tol,
        max_iters=cg_max_iters, precond=precond)
    alpha, probe_solves = solves[:, 0], solves[:, 1:]

    slq = slq_noise.to(r.dtype)
    if precond is not None:
        logdet = _slq_logdet_preconditioned(matvec, precond, precond.root(slq),
                                            lanczos_iters)
    else:
        logdet = _slq_logdet(matvec, slq, lanczos_iters)
    value = -0.5 * (alpha @ r) - 0.5 * logdet - 0.5 * n * math.log(2.0 * math.pi)

    # d/dtheta [-1/2 r^T K^-1 r] = 1/2 alpha^T G alpha and
    # d/dtheta [-1/2 logdet] = -1/2 E[(K^-1 z)^T G P^-1 z], G = dK/dtheta:
    # autograd of these scalar forms through the plain row-blocked matvec,
    # with the vectors held fixed. The JAX package runs this contraction
    # through XLA outside any Pallas kernel, on the TPU too, so here it is
    # the torch route on the card as well (two calls per evaluation).
    def contraction(kl):
        mv = _matvec(unflatten(kernel, kl), x, nugget, mesh, mesh_axis,
                     method="xla")
        quad = 0.5 * (alpha @ mv(alpha[:, None])[:, 0])
        tr = torch.mean(torch.sum(probe_solves * mv(probe_weights), dim=0))
        return quad - 0.5 * tr

    d_kernel = _leaf_grads(contraction, leaves(kernel), mesh, mesh_axis)
    d_mean = _grads_or_zeros(mean_val, ms, alpha.to(mean_val.dtype))
    return IterativeLogML(
        value=value.detach(),
        grads=Parameters(mean=unflatten(params.mean, d_mean),
                         kernel=unflatten(kernel, d_kernel)),
        cg_iters=cg_iters, cg_converged=cg_converged)
