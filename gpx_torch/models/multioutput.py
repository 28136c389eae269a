"""Multi-output GPs: intrinsic coregionalization (ICM) and the LMC — the
port of ``gpx/models/multioutput.py``.

T correlated outputs share a base kernel ``k`` over locations, coupled by
a PSD coregionalization matrix ``B = W W^T + diag(kappa)``, with
per-output observation noise on top:

    Cov[f_i(x), f_j(x')] = B[i, j] k(x, x'),
    y_i(x) = f_i(x) + e_i,   e_i ~ N(0, noise_i).

With shared noise the (NT x NT) operator ``B (x) K + s2 I`` is
diagonalized by ``eigh(K)`` (N x N) and ``eigh(B)`` (T x T), and the logML,
the posterior mean and the marginal variance become (N, T)-shaped
products (``method="kron"``); per-output noise, a mask or an LMC take the
dense (NT) Cholesky (``method="dense"``). :class:`LmcParams` is the linear
model of coregionalization, ``K = sum_q B_q (x) K_q``, Q latent processes
with their own kernels, on the dense path.

On the card, in float32, every ``K_q`` and cross block comes from the CUDA
Gram kernel; ``eigh``, the factor and the solves are ``torch.linalg``'s
with TF32 off. Parameter trees are :class:`~gpx_torch._module.FieldModule`
s with the JAX package's leaf order. Draws take a ``torch.Generator`` where
the JAX package takes a key; :func:`optimize`, :func:`sample_mh` and
:func:`sample_nuts` run the port's generic cores.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from gpx_torch import bijectors as bij
from gpx_torch._device import as_tensor, full_fp32, generators
from gpx_torch._module import FieldModule
from gpx_torch.distributions import normal_interval
from gpx_torch.models import gp
from gpx_torch.ops import chol
from gpx_torch.ops.distance import as_locations
from gpx_torch.params import leaves


class IcmParams(FieldModule):
    """ICM hyperparameters: base kernel, coregionalization and noise.

    ``w``: (T, R) loadings; ``kappa``: (T,) diagonal boost (keeps ``B``
    full-rank for R < T); ``noise``: scalar (shared, which allows the
    Kronecker path) or (T,) per-output observation noise variance."""

    _fields = ("kernel", "w", "kappa", "noise")

    def __init__(self, kernel, w, kappa, noise):
        super().__init__(kernel=kernel, w=w, kappa=kappa, noise=noise)

    @property
    def n_outputs(self) -> int:
        return self.w.shape[0]

    def bijectors(self) -> "IcmParams":
        return IcmParams(kernel=self.kernel.bijectors(), w=bij.identity,
                         kappa=bij.positive, noise=bij.positive)


def _staggered_w(n_outputs: int, rank: int, like, offset: float = 0.0):
    """The JAX package's default loadings ``(1 + 0.05 t + offset) /
    sqrt(rank)``, (T, rank), on ``like``'s device and in its type: an
    exactly symmetric ``W`` would give ``B`` a repeated eigenvalue."""
    ramp = 1.0 + 0.05 * torch.arange(n_outputs, dtype=like.dtype,
                                     device=like.device)[:, None] + offset
    return ramp * torch.full((n_outputs, rank), 1.0 / math.sqrt(rank),
                             dtype=like.dtype, device=like.device)


def _on(like, v):
    return as_tensor(v, device=like.device, dtype=like.dtype)


def icm(kernel, n_outputs: int, rank: int = 1, *, w=None, kappa=1.0,
        noise=0.1) -> IcmParams:
    """Convenience constructor, on the kernel's device and in its type;
    ``w`` defaults to a staggered near-equal coupling (:func:`_staggered_w`)."""
    like = leaves(kernel)[0]
    w = _staggered_w(n_outputs, rank, like) if w is None else _on(like, w)
    kappa = _on(like, kappa).broadcast_to((n_outputs,)).clone()
    return IcmParams(kernel=kernel, w=w, kappa=kappa, noise=_on(like, noise))


class LmcTerm(FieldModule):
    """One latent process of an LMC: a base kernel and its
    coregionalization ``B_q = W_q W_q^T + diag(kappa_q)``."""

    _fields = ("kernel", "w", "kappa")

    def __init__(self, kernel, w, kappa):
        super().__init__(kernel=kernel, w=w, kappa=kappa)

    def bijectors(self) -> "LmcTerm":
        return LmcTerm(kernel=self.kernel.bijectors(), w=bij.identity,
                       kappa=bij.positive)


class LmcParams(FieldModule):
    """Linear model of coregionalization: ``Cov[f_i(x), f_j(x')] = sum_q
    B_q[i, j] k_q(x, x')``. A sum of Kronecker products has no joint
    diagonalization, so every LMC path is dense."""

    _fields = ("terms", "noise")

    def __init__(self, terms, noise):
        super().__init__(terms=tuple(terms), noise=noise)

    @property
    def n_outputs(self) -> int:
        return self.terms[0].w.shape[0]

    def bijectors(self) -> "LmcParams":
        return LmcParams(terms=tuple(t.bijectors() for t in self.terms),
                         noise=bij.positive)


def lmc(kernels, n_outputs: int, rank: int = 1, *, kappa=1.0,
        noise=0.1) -> LmcParams:
    """Convenience constructor: one LMC term per base kernel, each with a
    staggered rank-``rank`` loading (see :func:`icm`)."""
    terms = []
    for q, k in enumerate(kernels):
        like = leaves(k)[0]
        terms.append(LmcTerm(
            kernel=k, w=_staggered_w(n_outputs, rank, like, 0.01 * q),
            kappa=_on(like, kappa).broadcast_to((n_outputs,)).clone()))
    return LmcParams(terms=tuple(terms),
                     noise=_on(leaves(kernels[0])[0], noise))


def coregion_matrix(p) -> torch.Tensor:
    """``B = W W^T + diag(kappa)``, (T, T); for an LMC, the sum over terms."""
    if isinstance(p, LmcParams):
        bs = [coregion_matrix(t) for t in p.terms]
        return sum(bs[1:], bs[0])
    return p.w @ p.w.T + torch.diag(p.kappa)


def _terms(p):
    """A tuple of ``(kernel, B_q)`` pairs: one for an ICM, Q for an LMC."""
    if isinstance(p, LmcParams):
        return tuple((t.kernel, coregion_matrix(t)) for t in p.terms)
    return ((p.kernel, coregion_matrix(p)),)


def _check_xy(x, Y, p):
    x = as_locations(x)
    Y = as_tensor(Y, device=x.device)
    if Y.ndim != 2:
        raise ValueError(f"multi-output observations must be (N, T); got "
                         f"shape {tuple(Y.shape)}")
    if Y.shape[0] != x.shape[0]:
        raise ValueError(f"x has {x.shape[0]} locations but Y has "
                         f"{Y.shape[0]} rows")
    if Y.shape[1] != p.n_outputs:
        raise ValueError(f"params declare {p.n_outputs} outputs but Y has "
                         f"{Y.shape[1]} columns")
    return x, Y


def _noise_vec(p) -> torch.Tensor:
    return p.noise.broadcast_to((p.n_outputs,))


def _is_shared_noise(p) -> bool:
    return p.noise.ndim == 0


def gram_full(p, x, *, nugget: float = 0.0) -> torch.Tensor:
    """The dense (NT, NT) covariance ``sum_q B_q (x) K_q + diag(noise) (x) I
    + nugget I`` in output-major order (flat index = output N + location):
    the dense path's operator; the Kronecker path never builds it."""
    full_fp32()
    x = as_locations(x)
    n = x.shape[0]
    full = sum(torch.kron(b, kern.gram(x)) for kern, b in _terms(p))
    d = torch.repeat_interleave(_noise_vec(p), n) + nugget
    return full + torch.diag(d)


def _kron_eig(p: IcmParams, kxx, b, nugget):
    """Eigen-split of ``B (x) K + (s2 + nugget) I`` from the Gram ``kxx``
    and ``b = B``: ``(Qk, lam_k, Qb, lam_b, S)`` with ``S[n, a] = lam_k[n]
    lam_b[a] + s2 + nugget``, the operator's spectrum as (N, T). The small
    negative float32 eigenvalues of the PSD factors are clamped at 0; the
    noise keeps ``S`` positive."""
    full_fp32()
    lam_k, qk = chol.eigh(kxx)
    lam_b, qb = chol.eigh(b)
    lam_k = torch.clamp_min(lam_k, 0.0)
    lam_b = torch.clamp_min(lam_b, 0.0)
    s = lam_k[:, None] * lam_b[None, :] + p.noise + nugget
    return qk, lam_k, qb, lam_b, s


def _kron_logml(p: IcmParams, x, Y, nugget):
    """The Kronecker logML, whose gradient never differentiates ``eigh``:
    the value from the eigenbases of ``Kx`` and ``B``, the gradient from
    :func:`_held_basis_surrogate` on the axes ``(Kx, B)`` (``vec Y`` in C
    order is ``Kx (x) B``'s), which autograd carries to the kernel's
    leaves, ``W`` and ``kappa``."""
    n, t = Y.shape
    full_fp32()
    kxx, b = p.kernel.gram(x), coregion_matrix(p)
    with torch.no_grad():
        qk, lam_k, qb, lam_b, s = _kron_eig(p, kxx, b, nugget)
        w = (qk.T @ Y) @ qb
        quad = torch.sum(w * w / s)
        logdet = torch.sum(torch.log(s))
        value = -0.5 * (quad + logdet + n * t * math.log(2.0 * math.pi))
    live = (kxx, b, p.noise, Y)
    if not (torch.is_grad_enabled() and any(v.requires_grad for v in live)):
        return value
    with torch.no_grad():
        alpha = (qk @ (w / s)) @ qb.T                # mat(K^-1 vec Y), (N, T)
    return _with_gradient(value, _held_basis_surrogate(
        [kxx, b], [qk, qb], [lam_k, lam_b], s, alpha, p.noise, Y))


def _held_basis_surrogate(grams, qs, lams, s, alpha, noise, Y):
    """A surrogate whose gradient is that of ``log N(vec Y | 0, K)``, ``K =
    (x)_d K_d + s2 I`` with ``K_d = Q_d diag(lams[d]) Q_d^T``, with the
    eigenbases held constant; ``s`` is K's spectrum and ``alpha`` ``K^-1
    vec Y``, both in grid shape. The derivative is ``1/2 a^T dK a - 1/2
    tr(K^-1 dK)``: on axis d the trace is ``tr(W_d dK_d)`` with ``W_d =
    Q_d diag(sum over the other axes' indices of prod_{e != d} lam_e / S)
    Q_d^T``, the quadratic form's weight is ``alpha`` contracted with
    itself over the other axes through their Grams (``A B A^T`` and ``A^T
    Kx A`` for two axes, ``A = mat(alpha)``), and the noise's is ``sum 1 /
    S - |alpha|^2``. The weights are detached. Inside a degenerate
    eigenspace they are equal, so the gradient does not depend on the
    basis ``eigh`` picks there, and no eigenvalue gap divides anything
    (``eigh``'s VJP does both)."""
    nd = len(grams)
    with torch.no_grad():
        inv_s = 1.0 / s
        weights = []
        for d in range(nd):
            others = [e for e in range(nd) if e != d]
            v, m = inv_s, alpha
            for e in others:
                v = v * lams[e].reshape([-1 if i == e else 1
                                         for i in range(nd)])
                m = torch.movedim(torch.tensordot(grams[e], m,
                                                  dims=([1], [e])), 0, e)
            v = torch.sum(v, dim=others) if others else v
            a_d = torch.tensordot(alpha, m, dims=(others, others))
            weights.append((qs[d] * v[None, :]) @ qs[d].T - a_d)
        g_s = torch.sum(inv_s) - torch.sum(alpha * alpha)
    return -0.5 * (sum(torch.sum(w * g) for w, g in zip(weights, grams))
                   + g_s * noise) - torch.sum(alpha * Y)


def _with_gradient(value, surrogate):
    """``value``, bitwise, with the gradient of ``surrogate`` (a function
    of the live inputs whose weights are detached)."""
    return value + (surrogate - surrogate.detach())


def _obs_index(mask, n, t):
    """Flat output-major indices (a CPU int64 tensor) of the observed
    entries of an (N, T) boolean mask. The mask must be concrete on the
    host (numpy, or a CPU tensor): the observed count sets the shapes."""
    if isinstance(mask, torch.Tensor):
        if mask.device.type != "cpu":
            raise ValueError("mask must be on the host (numpy or a CPU "
                             "tensor)")
        mask = mask.numpy()
    mask = np.asarray(mask)
    if mask.shape != (n, t):
        raise ValueError(f"mask must be (N, T) = {(n, t)}; got {mask.shape}")
    if mask.dtype != np.bool_:
        raise ValueError("mask must be boolean (True = observed)")
    return torch.from_numpy(np.flatnonzero(mask.T.reshape(-1)))


def _route(p, method, mask):
    if isinstance(p, LmcParams) and method == "kron":
        raise ValueError("method='kron' is ICM-only: a sum of Kronecker "
                         "products has no joint diagonalization; LMC "
                         "inference is dense")
    if mask is not None or isinstance(p, LmcParams):
        return "dense"
    if method == "auto":
        return "kron" if _is_shared_noise(p) else "dense"
    if method == "kron" and not _is_shared_noise(p):
        raise ValueError("method='kron' needs scalar (shared) noise: "
                         "per-output noise breaks the joint "
                         "diagonalization; use method='dense'")
    if method not in ("kron", "dense"):
        raise ValueError(f"unknown method: {method!r}")
    return method


def log_marginal_likelihood(p, x, Y, *, nugget: float = gp.LOGML_NUGGET,
                            method: str = "auto", mask=None) -> torch.Tensor:
    """``log N(vec Y | 0, B (x) K + D (x) I)`` (zero prior mean; centre
    ``Y`` for anything else).

    ``method``: ``"kron"`` (shared noise; two eigendecompositions, nothing
    NT-sized), ``"dense"`` (the NT Cholesky; any noise) or ``"auto"``. The
    Kronecker path's gradient holds the eigenbases constant
    (:func:`_kron_logml`): it is defined at repeated eigenvalues of B or
    K, where ``eigh``'s VJP is not. ``mask`` (N, T) boolean, True = observed,
    selects the observed sub-block (dense path); masked-out entries of
    ``Y`` may hold NaN."""
    x, Y = _check_xy(x, Y, p)
    n, t = Y.shape
    if _route(p, method, mask) == "kron":
        return _kron_logml(p, x, Y, nugget)
    kfull = gram_full(p, x, nugget=nugget)
    v = Y.T.reshape(-1)
    if mask is not None:
        ix = _obs_index(mask, n, t).to(x.device)
        kfull = kfull[ix][:, ix]
        v = torch.where(torch.isfinite(v), v, 0.0)[ix]
    l = chol.cholesky(kfull)
    u = chol.forward_solve(l, v)
    return (-0.5 * (u @ u) - torch.sum(torch.log(torch.diagonal(l)))
            - 0.5 * v.shape[0] * math.log(2.0 * math.pi))


def _randn(key, shape, like):
    return torch.randn(shape, generator=key, dtype=like.dtype,
                       device=key.device).to(like.device)


def draw(key, p, x, *, nugget: float = gp.LOGML_NUGGET,
         include_noise: bool = True) -> torch.Tensor:
    """One joint draw of all T outputs at ``x``, (N, T), by matrix-normal
    sampling: per latent process ``F_q = L_q Z_q Bh_q^T`` with ``L_q =
    chol(K_q + nugget I)`` and ``Bh_q`` the eigen square root of ``B_q``
    (a rank-deficient ``B`` is a valid model); an LMC draw sums the terms.
    ``key`` is a ``torch.Generator``: one (N, T) standard normal block per
    term, then the noise's."""
    full_fp32()
    x = as_locations(x)
    n, t = x.shape[0], p.n_outputs
    f = None
    for kern, bq in _terms(p):
        lk = chol.cholesky(kern.gram(x, nugget=nugget))
        lam_b, qb = chol.eigh(bq)
        bh = qb * torch.sqrt(torch.clamp_min(lam_b, 0.0))[None, :]
        fq = (lk @ _randn(key, (n, t), lk)) @ bh.T
        f = fq if f is None else f + fq
    if include_noise:
        f = f + torch.sqrt(_noise_vec(p))[None, :] * _randn(key, (n, t), f)
    return f


def _dense_cross_solve(p, x, Y, xs, nugget, mask):
    """The dense path's assembly for :func:`fit` and :func:`posterior_draw`:
    the factor of the (mask-subset) observed block, ``alpha = K^-1 vec Y``,
    the output-major cross-covariance columns ``C`` and ``V = L^-1 C`` (so
    ``V^T V = C^T K^-1 C``)."""
    n, t = Y.shape
    m = xs.shape[0]
    kfull = gram_full(p, x, nugget=nugget)
    yv = Y.T.reshape(-1)
    # the cross block of (output i, test s) is sum_q B_q[:, i] (x)
    # k_q(x, xs)[:, s], output-major on both axes
    cross = sum(torch.einsum("ji,nm->jnim", bq, kern.gram(x, xs))
                for kern, bq in _terms(p)).reshape(t * n, t * m)
    if mask is not None:
        ix = _obs_index(mask, n, t).to(x.device)
        kfull = kfull[ix][:, ix]
        yv = torch.where(torch.isfinite(yv), yv, 0.0)[ix]
        cross = cross[ix]
    l = chol.cholesky(kfull)
    alpha = chol.back_solve(l.T, chol.forward_solve(l, yv))
    v = chol.forward_solve(l, cross)
    return alpha, cross, v


def posterior_draw(key, p, x, Y, xs, *, nugget: float = gp.PREDICT_NUGGET,
                   jitter: float = 1e-8, shape=(),
                   include_noise: bool = True, mask=None) -> torch.Tensor:
    """Joint draw of all T outputs from the posterior at ``xs``, ``(*shape,
    M, T)``, through the Cholesky of the (MT x MT) posterior covariance:
    the draws carry the cross-output and cross-location dependence that
    :func:`fit`'s marginals lose. ``include_noise`` adds ``D (x) I``;
    ``mask`` conditions on an incomplete grid. ``key`` is a
    ``torch.Generator``."""
    x, Y = _check_xy(x, Y, p)
    xs = as_locations(as_tensor(xs, device=x.device, dtype=x.dtype))
    t = Y.shape[1]
    m = xs.shape[0]
    kss = sum(torch.einsum("ij,su->isju", bq, kern.gram(xs))
              for kern, bq in _terms(p)).reshape(t * m, t * m)
    if include_noise:
        kss = kss + torch.diag(torch.repeat_interleave(_noise_vec(p), m)
                               ).to(kss.dtype)
    alpha, cross, v = _dense_cross_solve(p, x, Y, xs, nugget, mask)
    mean = cross.T @ alpha                                   # (MT,)
    cov = kss - v.T @ v
    lp = chol.cholesky(cov + jitter * torch.eye(t * m, dtype=cov.dtype,
                                                device=cov.device))
    z = _randn(key, (*shape, t * m), lp)
    draws = mean + z @ lp.T
    return torch.movedim(draws.reshape(*shape, t, m), -2, -1)


class MultiOutputSummary(NamedTuple):
    """Marginal posterior over every output at M test locations."""

    x: torch.Tensor         # (M, D)
    mean: torch.Tensor      # (M, T)
    variance: torch.Tensor  # (M, T), observation noise included

    def interval(self, q):
        """Credible bound at quantile ``q`` per output."""
        return normal_interval(self.mean, self.variance, q)


def fit(p, x, Y, xs, *, nugget: float = gp.PREDICT_NUGGET,
        method: str = "auto", mask=None) -> MultiOutputSummary:
    """Posterior mean and variance of every output at ``xs`` (GPML Alg.
    2.1 through the Kronecker structure). Kron path: with ``W = Qk^T Y Qb``
    and the spectrum ``S``, the mean is ``K(xs, x) alpha B`` for ``alpha =
    Qk (W / S) Qb^T``, and the variance reduction at (test s, output i) is
    ``sum_na (Qk^T k_s)_n^2 (Qb^T B_i)_a^2 / S_na``. The variance includes
    the observation noise. ``mask`` conditions on an incomplete grid (dense
    path)."""
    full_fp32()
    x, Y = _check_xy(x, Y, p)
    xs = as_locations(as_tensor(xs, device=x.device, dtype=x.dtype))
    route = _route(p, method, mask)
    # the prior marginal variance sums over the latent processes
    prior_var = sum(kern.diag(xs)[:, None] * torch.diag(bq)[None, :]
                    for kern, bq in _terms(p))
    if route == "kron":
        b = coregion_matrix(p)
        kxs = p.kernel.gram(x, xs)                  # (N, M)
        qk, _, qb, _, s = _kron_eig(p, p.kernel.gram(x), b, nugget)
        w = (qk.T @ Y) @ qb
        alpha = (qk @ (w / s)) @ qb.T               # mat(K^-1 vec Y), (N, T)
        mean = (kxs.T @ alpha) @ b                  # (M, T)
        w2 = torch.square(qk.T @ kxs)               # (N, M)
        u2 = torch.square(qb.T @ b)                 # (T, T)
        red = (w2.T @ (1.0 / s)) @ u2               # (M, T)
    else:
        t, m = Y.shape[1], xs.shape[0]
        alpha, cross, v = _dense_cross_solve(p, x, Y, xs, nugget, mask)
        mean = (cross.T @ alpha).reshape(t, m).T
        red = torch.sum(v * v, dim=0).reshape(t, m).T
    variance = torch.clamp_min(prior_var - red, 0.0) + _noise_vec(p)[None, :]
    return MultiOutputSummary(x=xs, mean=mean, variance=variance)


def optimize(template, x, Y, *, nugget: float = gp.LOGML_NUGGET,
             log_prior: Callable | None = None, method: str = "auto",
             mask=None, steps: int = 100, optimizer: str = "lbfgs",
             learning_rate: float = 0.05, grad_tol: float = 1e-3,
             history_size: int = 10, key=None, n_probes: int = 16,
             lanczos_iters: int = 32, cg_tol: float = 1e-5,
             cg_max_iters: int = 1000, precond_rank: int = 0, mesh=None,
             mesh_axis: str = "data"):
    """Type-II MLE / MAP over every ICM or LMC hyperparameter through
    :func:`gpx_torch.models.optimize.optimize_log_density`. ``method=
    "iterative"`` optimizes the matrix-free estimate of
    :mod:`gpx_torch.models.multioutput_iterative` by Adam, with a fresh
    generator per step drawn from ``key`` (an int seed or a
    ``torch.Generator``; default 0); it takes no ``mask``."""
    from gpx_torch.models.optimize import (
        optimize_log_density, stochastic_log_density_vjp,
    )

    x, Y = _check_xy(x, Y, template)
    if method == "iterative":
        if optimizer != "adam":
            raise ValueError("method='iterative' has stochastic (SLQ / "
                             "Hutchinson) gradients: use optimizer='adam'")
        if mask is not None:
            raise ValueError("method='iterative' does not support mask=: "
                             "use the dense path")
        from gpx_torch.models.multioutput_iterative import (
            logml_value_and_grad_iterative,
        )

        def run(p, gen):
            return logml_value_and_grad_iterative(
                p, x, Y, gen, nugget=nugget, n_probes=n_probes,
                lanczos_iters=lanczos_iters, cg_tol=cg_tol,
                cg_max_iters=cg_max_iters, precond_rank=precond_rank,
                mesh=mesh, mesh_axis=mesh_axis)

        loglik = stochastic_log_density_vjp(run)

        def log_density(p, gen):
            val = loglik(p, gen)
            return val if log_prior is None else val + log_prior(p)

        return optimize_log_density(
            template, log_density, steps=steps, optimizer=optimizer,
            learning_rate=learning_rate, grad_tol=grad_tol,
            history_size=history_size,
            step_keys=generators(0 if key is None else key, steps + 1,
                                 x.device))

    def log_density(p):
        val = log_marginal_likelihood(p, x, Y, nugget=nugget, method=method,
                                      mask=mask)
        return val if log_prior is None else val + log_prior(p)

    return optimize_log_density(
        template, log_density, steps=steps, optimizer=optimizer,
        learning_rate=learning_rate, grad_tol=grad_tol,
        history_size=history_size)


def _log_density(x, Y, log_prior, nugget, method, mask):
    def log_density(p):
        return log_prior(p) + log_marginal_likelihood(
            p, x, Y, nugget=nugget, method=method, mask=mask)

    return log_density


def sample_mh(key, x, Y, template, log_prior: Callable, n_samples: int, *,
              proposal_scale: float = 0.1, n_chains: int = 4,
              burn_in: int = 0, thin: int = 1,
              nugget: float = gp.LOGML_NUGGET, init_jitter: float = 0.1,
              method: str = "auto", mask=None):
    """Random-walk MH over every multi-output hyperparameter (base
    kernel(s), W, kappa, noise) through the generic
    ``sample_mh_log_density``."""
    from gpx_torch.infer import sample_mh_log_density

    x, Y = _check_xy(x, Y, template)
    return sample_mh_log_density(
        key, template, _log_density(x, Y, log_prior, nugget, method, mask),
        n_samples, proposal_scale=proposal_scale, n_chains=n_chains,
        burn_in=burn_in, thin=thin, init_jitter=init_jitter)


def sample_nuts(key, x, Y, template, log_prior: Callable, n_samples: int, *,
                max_depth: int = 8, eps: float | None = None,
                warmup_iters: int = 500, adapt_mass: bool = False,
                n_chains: int = 4, burn_in: int = 0, thin: int = 1,
                nugget: float = gp.LOGML_NUGGET, init_jitter: float = 0.1,
                method: str = "auto", mask=None):
    """NUTS over every multi-output hyperparameter; the gradient is
    autograd's through the kron (eigenbases held constant) or dense
    (Cholesky) logML."""
    from gpx_torch.infer import sample_nuts_log_density

    x, Y = _check_xy(x, Y, template)
    return sample_nuts_log_density(
        key, template, _log_density(x, Y, log_prior, nugget, method, mask),
        n_samples, max_depth=max_depth, eps=eps, warmup_iters=warmup_iters,
        adapt_mass=adapt_mass, n_chains=n_chains, burn_in=burn_in,
        thin=thin, init_jitter=init_jitter)
