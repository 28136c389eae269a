"""Matrix-free multi-output GP inference for large-N ICM and LMC — the port
of ``gpx/models/multioutput_iterative.py``.

Every operation is a streamed Kronecker matvec

    (sum_q B_q (x) K_q + D (x) I) vec(V) = vec(sum_q mv_q(V) B_q + V diag(D))

where ``mv_q`` is the Gram matvec of :mod:`gpx_torch.ops.matvec` (K_q never
forms; on the card, in float32, the CUDA ``gram_matvec`` kernel) on all T R
columns at once, and ``B_q`` a (T, T) product. Memory is O(N (D + T R)).
The estimators are :mod:`gpx_torch.models.gp_iterative`'s (CG for the
quadratic term, SLQ for the logdet, Hutchinson for the gradient), on flat
output-major (NT,) vectors; the posterior mean takes the CUDA
``cross_matvec`` kernel.

With shared noise the pivoted-Cholesky Woodbury preconditioner extends
through the Kronecker structure: ``P = B (x) L_r L_r^T + s2 I`` is
diagonalized per output eigenvector by ``eigh(B)``, and each rotated column
is a standard Woodbury (:class:`KronWoodburyPreconditioner`).

Randomness comes from a ``torch.Generator``; the private core takes the
base noise, so tests can feed it the JAX package's draws. ``mesh=``
row-shards every K_q matvec over ``mesh[mesh_axis]``; vectors stay
replicated.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpx_torch._device import as_tensor, full_fp32
from gpx_torch.kernels import split_noise
from gpx_torch.models.gp import LOGML_NUGGET, PREDICT_NUGGET
from gpx_torch.models.gp_iterative import (
    _leaf_grads, _matvec, _normal, _rademacher, _slq_logdet,
    _slq_logdet_preconditioned, cg_solve, pivoted_cholesky,
)
from gpx_torch.models.multioutput import (
    LmcParams, _check_xy, _is_shared_noise, _noise_vec, _terms,
    coregion_matrix,
)
from gpx_torch.ops import chol
from gpx_torch.ops.distance import as_locations
from gpx_torch.ops.matvec import cross_matvec
from gpx_torch.params import leaves, unflatten


def _to_mat(v, n, t):
    """Flat output-major (NT, R) -> (N, T, R) (flat index = output N +
    location, ``multioutput.gram_full``'s order)."""
    return torch.movedim(v.reshape(t, n, -1), 0, 1)


def _to_flat(V):
    """(N, T, R) -> flat output-major (NT, R)."""
    n, t, r = V.shape
    return torch.movedim(V, 1, 0).reshape(t * n, r)


def kron_matvec(p, x, *, nugget: float = 0.0, mesh=None,
                mesh_axis: str = "data", method: str = "auto"):
    """``mv(v) = (sum_q B_q (x) K_q + (noise + nugget) I) v`` on flat
    output-major ``v``, (NT,) or (NT, R): per term one Gram matvec on all
    T R columns, then the (T, T) product. The default route is
    :func:`gpx_torch.ops.matvec.gram_matvec` (the CUDA kernel for float32
    on the card); ``method="xla"`` is the plain row-blocked torch route,
    differentiable in every hyperparameter (kernels, W, kappa, noise), for
    the gradient contraction. ``mesh=`` row-shards each Gram matvec over
    ``mesh[mesh_axis]`` (vectors stay replicated)."""
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown method: {method!r}")
    full_fp32()
    x = as_locations(x)
    n = x.shape[0]
    t = p.n_outputs
    terms = _terms(p)
    d = _noise_vec(p) + nugget                      # (T,) additive diagonal

    def mv_q(kern, cols):
        return _matvec(kern, x, 0.0, mesh, mesh_axis, method=method)(cols)

    def mv(v):
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v           # (NT, R)
        r = v2.shape[1]
        V = _to_mat(v2, n, t)                       # (N, T, R)
        cols = V.reshape(n, t * r)
        out = V * d[None, :, None]
        for kern, bq in terms:
            w = mv_q(kern, cols).reshape(n, t, r)   # K_q V per column
            out = out + torch.einsum("ntr,ts->nsr", w, bq)
        flat = _to_flat(out)
        return flat[:, 0] if squeeze else flat

    return mv


class KronWoodburyPreconditioner(NamedTuple):
    """``P = B (x) (L_r L_r^T + s_w I) + s2 I`` held jointly diagonalized:
    ``eigh(B) = Qb Lb Qb^T`` (T x T, exact) and the orthonormal (N, r)
    eigenbasis ``W`` of the base kernel's smooth part's pivoted Cholesky
    (its White part ``s_w`` split out, as the single-output path does, so
    the rank goes to the smooth spectrum). In the rotated basis ``(Qb^T (x)
    I)``, output column ``a`` is the standard Woodbury with spectrum
    ``lb[a] lam`` and its own floor ``noise[a] = lb[a] s_w + s2``, so the
    apply, the logdet and the square root are exact:

        log det P = sum_{a,i} log(lb[a] lam[i] + noise[a])
                    + (N - r) sum_a log noise[a].

    On flat output-major (NT,[R]) vectors."""

    w: torch.Tensor       # (N, r) orthonormal
    lam: torch.Tensor     # (r,) eigenvalues of L_r L_r^T, >= 0
    lam_b: torch.Tensor   # (T,) eigenvalues of B, >= 0
    qb: torch.Tensor      # (T, T) orthonormal
    noise: torch.Tensor   # (T,) per rotated column: lb s_w + s2
    n: int
    t: int

    def _rot(self, V, back: bool = False):
        sub = "nar,ta->ntr" if back else "ntr,ta->nar"
        return torch.einsum(sub, V, self.qb.to(V.dtype))

    def apply(self, v):
        squeeze = v.ndim == 1
        v2 = v[:, None] if squeeze else v
        V = self._rot(_to_mat(v2, self.n, self.t))      # (N, T, R) rotated
        w = self.w.to(V.dtype)
        lam_at = self.lam_b[:, None] * self.lam[None, :]  # (T, r)
        scale = (lam_at / (lam_at + self.noise[:, None])).to(V.dtype)
        tproj = torch.einsum("nk,nar->kar", w, V)
        out = (V - torch.einsum("nk,kar->nar", w,
                                scale.T[:, :, None] * tproj)
               ) / self.noise[None, :, None].to(V.dtype)
        flat = _to_flat(self._rot(out, back=True))
        return flat[:, 0] if squeeze else flat

    @property
    def logdet(self):
        rank = self.lam.shape[0]
        lam_at = self.lam_b[:, None] * self.lam[None, :]
        return torch.sum(torch.log(lam_at + self.noise[:, None])) + (
            self.n - rank) * torch.sum(torch.log(self.noise))

    def root(self, u):
        """``P^(1/2) u`` for a base block ``u`` (N, T, s), flat
        output-major (NT, s)."""
        lam_at = self.lam_b[:, None] * self.lam[None, :]  # (T, r)
        root = torch.sqrt(self.noise)                     # (T,)
        gain = torch.sqrt(lam_at + self.noise[:, None]) - root[:, None]
        tproj = torch.einsum("nk,nar->kar", self.w, u)
        z = torch.einsum("nk,kar->nar", self.w, gain.T[:, :, None] * tproj) \
            + root[None, :, None] * u
        return _to_flat(self._rot(z, back=True))

    def sample(self, key, n_probes: int, base: str = "normal"):
        """Probes ``z = P^(1/2) u`` (E[z z^T] = P for any unit-covariance
        ``u``) with ``u`` (N, T, s) from the generator ``key``: Normal, or
        Rademacher for the gradient probes."""
        draw = _rademacher if base == "rademacher" else _normal
        return self.root(draw(key, (self.n, self.t, n_probes), self.w.dtype,
                              self.w.device))


def _factor_eigenbasis(l_r):
    """``(W, lam)`` with ``L_r L_r^T = W diag(lam) W^T``, W orthonormal (N,
    r), from the reduced QR of the pivoted factor and ``eigh(R R^T)``,
    computed in float64 and rounded to the factor's type. On an H100,
    cuSOLVER's float32 QR of the ICM benchmark's factor (16,384 x 64, its
    last columns exactly zero once the pivots run out) returned ``||QR -
    L|| = 0.115 ||L||``: the preconditioner's logdet then ran 14,804 nats
    off and CG took 481 iterations for 4."""
    q, r_mat = torch.linalg.qr(l_r.double())
    lam, u = torch.linalg.eigh(r_mat @ r_mat.T)
    return (q @ u).to(l_r.dtype), torch.clamp_min(lam, 0.0).to(l_r.dtype)


def kron_preconditioner(p, x, rank: int, *,
                        nugget: float = 0.0) -> KronWoodburyPreconditioner:
    """The Kronecker Woodbury of an ICM with shared noise: the pivoted
    Cholesky (rank ``rank``) of the base kernel's smooth part and the exact
    ``eigh(B)``; a White part of the base kernel joins the per-column
    noise floor instead of taking rank."""
    if isinstance(p, LmcParams):
        raise ValueError("preconditioning is ICM-only: an LMC's sum of "
                         "Kronecker products has no joint (B, K) eigen-split; "
                         "use precond_rank=0")
    if not _is_shared_noise(p):
        raise ValueError("preconditioning needs scalar (shared) noise: "
                         "per-output noise breaks the output-axis rotation; "
                         "use precond_rank=0")
    full_fp32()
    x = as_locations(x)
    smooth, noise_w = split_noise(p.kernel)
    if smooth is None:
        raise ValueError("the ICM base kernel is pure White: there is no "
                         "smooth spectrum to precondition; use "
                         "precond_rank=0")
    w, lam = _factor_eigenbasis(pivoted_cholesky(smooth, x, rank))
    lam_b, qb = chol.eigh(coregion_matrix(p))
    lam_b = torch.clamp_min(lam_b, 0.0)
    floor = p.noise + nugget + 1e-8
    return KronWoodburyPreconditioner(
        w=w, lam=lam, lam_b=lam_b, qb=qb, noise=lam_b * noise_w + floor,
        n=x.shape[0], t=p.n_outputs)


class IterativeMoLogML(NamedTuple):
    value: torch.Tensor
    grads: object                  # an IcmParams- or LmcParams-shaped tree
    cg_iters: int
    cg_converged: bool


def logml_value_and_grad_iterative(
        p, x, Y, key, *, nugget: float = LOGML_NUGGET, n_probes: int = 16,
        lanczos_iters: int = 32, cg_tol: float = 1e-5,
        cg_max_iters: int = 1000, precond_rank: int = 0, mesh=None,
        mesh_axis: str = "data") -> IterativeMoLogML:
    """Matrix-free multi-output logML and hyperparameter-gradient estimate
    of ``log N(vec Y | 0, sum_q B_q (x) K_q + D (x) I)``: CG for the
    quadratic term (exact to ``cg_tol``), SLQ for the logdet, Hutchinson
    probes for the gradient's trace, against the streamed Kronecker
    matvec. The gradient covers every leaf: the kernels through the
    differentiable torch matvec, ``W`` and ``kappa`` through the (T, T)
    contraction, the noise through the diagonal. ``key`` is a
    ``torch.Generator``: it draws the gradient probes' Rademacher base,
    then the SLQ base (Normal with a preconditioner, else Rademacher).
    ``precond_rank > 0`` builds the Kronecker Woodbury (ICM, shared noise
    only). ``mesh=`` row-shards every K_q matvec over
    ``mesh[mesh_axis]``."""
    x, Y = _check_xy(x, Y, p)
    n, t = Y.shape
    shape = (n, t, n_probes) if precond_rank > 0 else (n * t, n_probes)
    probe_noise = _rademacher(key, shape, Y.dtype, x.device)
    draw = _normal if precond_rank > 0 else _rademacher
    slq_noise = draw(key, shape, Y.dtype, x.device)
    return _logml_value_and_grad_iterative(
        p, x, Y, probe_noise=probe_noise, slq_noise=slq_noise, nugget=nugget,
        lanczos_iters=lanczos_iters, cg_tol=cg_tol, cg_max_iters=cg_max_iters,
        precond_rank=precond_rank, mesh=mesh, mesh_axis=mesh_axis)


def _logml_value_and_grad_iterative(p, x, Y, *, probe_noise, slq_noise,
                                    nugget: float = LOGML_NUGGET,
                                    lanczos_iters: int = 32,
                                    cg_tol: float = 1e-5,
                                    cg_max_iters: int = 1000,
                                    precond_rank: int = 0, mesh=None,
                                    mesh_axis: str = "data"
                                    ) -> IterativeMoLogML:
    """The estimator on given base noise: (N, T, s) blocks taken through
    ``P^(1/2)`` with a preconditioner, else flat (NT, s) Rademacher probes
    used as they are; ``probe_noise`` for the gradient, ``slq_noise`` for
    the logdet."""
    full_fp32()
    x, Y = _check_xy(x, Y, p)
    n, t = Y.shape
    nt = n * t
    matvec = kron_matvec(p, x, nugget=nugget, mesh=mesh, mesh_axis=mesh_axis)
    precond = (kron_preconditioner(p, x, precond_rank, nugget=nugget)
               if precond_rank > 0 else None)
    y = Y.T.reshape(-1)                               # flat output-major

    probes = probe_noise.to(y.dtype)
    if precond is not None:
        probes = precond.root(probes).to(y.dtype)
        probe_weights = precond.apply(probes)
    else:
        probe_weights = probes
    solves, cg_iters, cg_converged = cg_solve(
        matvec, torch.cat([y[:, None], probes], dim=1), tol=cg_tol,
        max_iters=cg_max_iters, precond=precond)
    alpha, probe_solves = solves[:, 0], solves[:, 1:]

    slq = slq_noise.to(y.dtype)
    if precond is not None:
        logdet = _slq_logdet_preconditioned(matvec, precond, precond.root(slq),
                                            lanczos_iters)
    else:
        logdet = _slq_logdet(matvec, slq, lanczos_iters)
    value = -0.5 * (alpha @ y) - 0.5 * logdet - 0.5 * nt * math.log(
        2.0 * math.pi)

    # d/dtheta [-1/2 y^T K^-1 y] = 1/2 alpha^T G alpha and d/dtheta [-1/2
    # logdet] = -1/2 E[(K^-1 z)^T G P^-1 z], G = dK/dtheta: autograd of
    # these scalar forms through the plain torch matvec, vectors held fixed
    def contraction(ls):
        mv_d = kron_matvec(unflatten(p, ls), x, nugget=nugget, mesh=mesh,
                           mesh_axis=mesh_axis, method="xla")
        quad = 0.5 * (alpha @ mv_d(alpha[:, None])[:, 0])
        tr = torch.mean(torch.sum(probe_solves * mv_d(probe_weights), dim=0))
        return quad - 0.5 * tr

    grads = _leaf_grads(contraction, leaves(p), mesh, mesh_axis)
    return IterativeMoLogML(value=value.detach(), grads=unflatten(p, grads),
                            cg_iters=cg_iters, cg_converged=cg_converged)


class IterativeMoPosterior(NamedTuple):
    x: torch.Tensor
    mean: torch.Tensor             # (M, T)
    variance: torch.Tensor         # (M, T); (0, 0) when variance="none"
    cg_iters: int
    cg_converged: bool

    def interval(self, q):
        from gpx_torch.distributions import normal_interval

        return normal_interval(self.mean, self.variance, q)


def fit_iterative(p, x, Y, xs, *, nugget: float = PREDICT_NUGGET,
                  cg_tol: float = 1e-5, cg_max_iters: int = 1000,
                  precond_rank: int = 0, variance: str = "exact",
                  variance_block: int = 32, mesh=None,
                  mesh_axis: str = "data") -> IterativeMoPosterior:
    """Matrix-free multi-output posterior at ``xs`` (zero prior mean; the
    variance includes the observation noise, as
    :func:`gpx_torch.models.multioutput.fit`).

    * mean: one CG solve for ``A = mat(K^-1 vec Y)`` (N, T), then per term
      the streamed cross product ``K_q(xs, x) A B_q`` (the CUDA
      ``cross_matvec`` kernel for float32 on the card);
    * variance ``"exact"``: per block of ``variance_block`` test points,
      batched CG on all T block cross columns, memory O(N T^2 block);
      ``"none"`` skips it."""
    if variance not in ("exact", "none"):
        raise ValueError(f"unknown variance mode: {variance}")
    full_fp32()
    x, Y = _check_xy(x, Y, p)
    xs = as_locations(as_tensor(xs, device=x.device, dtype=x.dtype))
    n, t = Y.shape
    m = xs.shape[0]
    terms = _terms(p)
    matvec = kron_matvec(p, x, nugget=nugget, mesh=mesh, mesh_axis=mesh_axis)
    precond = (kron_preconditioner(p, x, precond_rank, nugget=nugget)
               if precond_rank > 0 else None)

    alpha, cg_iters, cg_converged = cg_solve(
        matvec, Y.T.reshape(-1), tol=cg_tol, max_iters=cg_max_iters,
        precond=precond)
    a_mat = _to_mat(alpha[:, None], n, t)[..., 0]            # (N, T)
    mean = sum(cross_matvec(kern, xs, x, a_mat) @ bq for kern, bq in terms)
    if variance == "none":
        return IterativeMoPosterior(xs, mean, mean.new_zeros((0, 0)),
                                    cg_iters, cg_converged)

    prior_var = sum(kern.diag(xs, dtype=mean.dtype)[:, None]
                    * torch.diag(bq)[None, :] for kern, bq in terms)
    # whole blocks, the last padded with points at the origin, as gpx
    xs_p = torch.nn.functional.pad(xs, (0, 0, 0, (-m) % variance_block))
    reds = []
    for b0 in range(0, xs_p.shape[0], variance_block):
        xb = xs_p[b0:b0 + variance_block]
        # cross columns of (test s, output i): C[:, j, (s, i)] = sum_q
        # B_q[j, i] k_q(x, .)[:, s], an (N, T, b T) block
        cross = _to_flat(sum(
            torch.einsum("ji,ns->njsi", bq, kern.gram(x, xb))
            for kern, bq in terms).reshape(n, t, variance_block * t))
        sol, _, ok = cg_solve(matvec, cross, tol=cg_tol,
                              max_iters=cg_max_iters, precond=precond)
        reds.append(torch.sum(cross * sol, dim=0).reshape(variance_block, t))
        cg_converged = cg_converged and ok
    red = torch.cat(reds)[:m]
    var = torch.clamp_min(prior_var - red, 0.0) + _noise_vec(p)[None, :]
    return IterativeMoPosterior(xs, mean, var, cg_iters, cg_converged)
