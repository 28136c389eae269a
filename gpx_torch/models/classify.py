"""Multi-class GP classification by the Laplace approximation — the port of
``gpx/models/classify.py`` (the reference's ``Classify``, with its softmax
likelihood, GPML Algorithm 3.3's Newton iteration for the posterior mode
and the approximate marginal likelihood, and GPML Algorithm 3.4's
prediction, which the reference leaves unimplemented).

The classes are the leading axis of a stacked (C, N, N) Gram, so each
Newton step is one batched Cholesky (``torch.linalg.cholesky_ex``, NaN
where a factor fails, as the JAX package's) and batched triangular solves
and products, in full float32 on the card; E's N-term sums are taken in
float64. The per-class Grams and cross
Grams come from :func:`gpx_torch.ops.gram.gram`: on float32 card tensors,
the CUDA Gram kernel. The Newton loop runs in Python and reads one scalar
to the host per iteration, the objective's change, for the JAX package's
stopping rule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpx_torch._device import as_tensor, full_fp32
from gpx_torch.ops import chol
from gpx_torch.ops.distance import as_locations
from gpx_torch.ops.gram import gram


def softmax_probs(f):
    """Class probabilities per data point; ``f: (C, N)`` latent values."""
    return torch.softmax(f, dim=0)


def encode_labels(y, n_classes: int):
    """One-hot encode as (C, N), in ``y``'s device and torch's default
    float type (cast it as needed)."""
    y = torch.as_tensor(y)
    return torch.nn.functional.one_hot(
        y.long(), n_classes).T.to(torch.get_default_dtype())


def softmax_log_likelihood(f, y_onehot):
    """Multi-class log-likelihood ``sum_i [f_{y_i, i} - logsumexp_c
    f_{c, i}]``."""
    return torch.sum(torch.sum(y_onehot * f, dim=0)
                     - torch.logsumexp(f, dim=0))


class LaplaceFit(NamedTuple):
    f: torch.Tensor             # (C, N) posterior mode
    pi: torch.Tensor            # (C, N) class probabilities at the mode
    log_marginal: torch.Tensor  # Laplace approximate log Z
    e: torch.Tensor             # (C, N, N) per-class E matrices
    m_chol: torch.Tensor        # (N, N) chol(sum_c E_c)
    k: torch.Tensor             # (C, N, N) per-class Grams
    y_onehot: torch.Tensor      # (C, N)
    n_iters: torch.Tensor


def _newton_quantities(f, k, y_onehot):
    """One Newton step of GPML Algorithm 3.3, batched over classes:
    ``(f_new, a, pi, E, chol(sum_c E_c), z)`` with ``z_c`` the half
    log-determinant of ``I + D_c^1/2 K_c D_c^1/2``."""
    n = f.shape[1]
    pi = softmax_probs(f)
    sqrt_pi = torch.sqrt(pi)
    # each (C, N, N) stack is freed once used: 2.7 GB in float32 at C =
    # 10, N = 8192
    dk = sqrt_pi[:, :, None] * k * sqrt_pi[:, None, :]
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    lc = chol.cholesky(eye + dk)                             # (C, N, N)
    del dk
    inner = torch.linalg.solve_triangular(lc, torch.diag_embed(sqrt_pi),
                                          upper=False)
    # E = D^1/2 (I + D^1/2 K D^1/2)^-1 D^1/2, its N-term sums taken in
    # float64 and rounded: the step's f = K a carries E's error times K's
    # norm, and a float32 product that sums each entry in order (cuBLAS's:
    # 2.2e-5 of E's norm at N = 8192 on an H100, 22x LAPACK's) throws the
    # float32 Newton loop off at C = 10, N = 8192 (chip_smoke.py
    # --newton-lockstep)
    wide = inner.double()
    e = (wide.mT @ wide).to(inner.dtype)
    del inner, wide
    z = torch.sum(torch.log(torch.diagonal(lc, dim1=-2, dim2=-1)), dim=-1)
    del lc
    m_chol = chol.cholesky(torch.sum(e, dim=0))

    # b = (D - Pi Pi^T) f + y - pi   [W f + grad log p(y|f)]
    pif = torch.sum(pi * f, dim=0)
    b = pi * f - pi * pif[None, :] + y_onehot - pi
    cvec = _bmv(e, _bmv(k, b))
    rc = torch.sum(cvec, dim=0)                              # R^T c
    sol = _back_then_forward(m_chol, rc)                     # M^T \ (M \ R^T c)
    a = b - cvec + torch.einsum("cij,j->ci", e, sol)
    f_new = _bmv(k, a)
    return f_new, a, pi, e, m_chol, z


def _bmv(m, v):
    """``out[c] = m[c] @ v[c]``: the per-class matvecs."""
    return torch.einsum("cij,cj->ci", m, v)


def _back_then_forward(m_chol, rhs):
    """``M^-T (M^-1 rhs)`` from the lower factor ``M``."""
    return chol.back_solve(m_chol.T, chol.forward_solve(m_chol, rhs))


def _per_class(kernels, n_classes):
    if isinstance(kernels, (list, tuple)):
        return list(kernels)
    return [kernels] * n_classes


def fit(x, kernels, y, n_classes: int, *, jitter: float = 1e-6,
        tol: float = 1e-4, max_iters: int = 50) -> LaplaceFit:
    """The softmax-Laplace posterior mode by Newton's method, until the
    objective ``psi(f) = -a^T f / 2 + log p(y | f)`` moves by at most
    ``tol`` or ``max_iters`` steps were taken. ``kernels``: one kernel,
    shared by the classes, or a list of C kernels. ``y``: integer labels
    (N,)."""
    full_fp32()
    x = as_locations(x)
    n = x.shape[0]
    k = torch.stack([gram(kern, x, nugget=jitter)
                     for kern in _per_class(kernels, n_classes)])
    y_onehot = encode_labels(as_tensor(y, device=x.device),
                             n_classes).to(k.dtype)

    def objective(f, a):
        return -0.5 * torch.sum(a * f) + softmax_log_likelihood(f, y_onehot)

    f = torch.zeros((n_classes, n), dtype=k.dtype, device=k.device)
    a = torch.zeros_like(f)
    obj, obj_prev = f.new_tensor(1.0), f.new_tensor(0.0)
    it = 0
    # one host read an iteration: the stopping rule's change in psi
    while float(torch.abs(obj - obj_prev)) > tol and it < max_iters:
        f, a, *_ = _newton_quantities(f, k, y_onehot)
        obj, obj_prev = objective(f, a), obj
        it += 1

    # the quantities at the mode and the approximate log marginal likelihood
    _, _, pi, e, m_chol, z = _newton_quantities(f, k, y_onehot)
    log_z = objective(f, a) - torch.sum(z)
    return LaplaceFit(f=f, pi=pi, log_marginal=log_z, e=e, m_chol=m_chol,
                      k=k, y_onehot=y_onehot,
                      n_iters=torch.tensor(it, device=k.device))


def latent_predict(fitres: LaplaceFit, x, kernels, xs):
    """Latent predictive moments at test locations (the mean and
    covariance half of GPML Algorithm 3.4): ``mu (C, M)`` and the
    per-test-point cross-class covariance ``sigma (M, C, C)``."""
    full_fp32()
    x = as_locations(x)
    xs = as_locations(as_tensor(xs, device=x.device, dtype=x.dtype))
    c = fitres.f.shape[0]
    kernels = _per_class(kernels, c)
    kxs = torch.stack([gram(kern, x, xs) for kern in kernels])  # (C, N, M)
    kss = torch.stack([kern.diag(xs, dtype=fitres.f.dtype)
                       for kern in kernels])                     # (C, M)
    diff = fitres.y_onehot - fitres.pi
    mu = torch.einsum("cn,cnm->cm", diff, kxs)
    b = fitres.e @ kxs                                           # (C, N, M)
    # the solve stays per class, over all C * M columns: Sigma*_{cd} =
    # b_c^T (sum E)^-1 b_d + delta_cd (kss - b_c^T k*_c). Summing b over
    # the classes before the solve would drop the -b^T k* term and give
    # the prior's variance.
    n, m = b.shape[1], b.shape[2]
    sol = _back_then_forward(fitres.m_chol,
                             torch.movedim(b, 1, 0).reshape(n, c * m))
    sol = torch.movedim(sol.reshape(n, c, m), 0, 1)              # (C, N, M)
    sigma = torch.einsum("cim,dim->mcd", b, sol)                 # (M, C, C)
    diag_term = kss.T - torch.einsum("cim,cim->mc", b, kxs)      # (M, C)
    return mu, sigma + torch.diag_embed(diag_term)


def predict(key, fitres: LaplaceFit, x, kernels, xs, *,
            n_classes: int | None = None, n_mc: int = 2000):
    """Class probabilities at test locations, (M, C) (GPML Algorithm 3.4):
    the softmax averaged over ``n_mc`` draws from the Gaussian latent
    posterior at each test point. ``key`` is a ``torch.Generator``: one
    (M, n_mc, C) block of standard normals."""
    mu, sigma = latent_predict(fitres, x, kernels, xs)
    c = fitres.f.shape[0]
    eye = torch.eye(c, dtype=sigma.dtype, device=sigma.device)
    lp = chol.cholesky(sigma + 1e-6 * eye)                       # (M, C, C)
    zs = torch.randn((mu.shape[1], n_mc, c), generator=key,
                     dtype=sigma.dtype, device=key.device).to(sigma.device)
    fs = mu.T[:, None, :] + zs @ lp.mT
    return torch.mean(torch.softmax(fs, dim=-1), dim=1)
