"""The probe kernel's arithmetic on the CPU: its plain TF32 version
(``probe_what_tf32x3``: one 2s-deep product of [U | Z] and [Z | U], both
split into TF32 hi/lo, the three products lo*hi + hi*lo + hi*hi, each
64-deep slab rounded to float32, float64 across slabs) against float64, in
float32 ulps of each entry's sum of |terms|, at n = 256 for Rademacher
probes, a Gaussian (augmented-like, not +-1) block and a ragged s = 41. A
1-pass version (hi*hi alone) lands far outside the limit. The contraction
through the plain TF32 version meets ``logml_probe_grads_reference`` in
float64 within the limits ``chip_smoke.py`` holds the kernel to. The
float64 plain route is held against the JAX package in
``test_torch_grad.py`` and ``test_torch_hybrid.py``."""

import functools

import numpy as np
import pytest
import torch

import gpx_torch as gt
from gpx_torch.ops import cuda_logml_grad as clg
from gpx_torch.ops.distance import sq_distances
from gpx_torch.ops.terms import term_derivatives, term_dr2

EPS32 = 2.0 ** -23
ULPS = 4.0  # chip_smoke.py: _hold's limit, 4 f32 ulps of each sum of |terms|
N = 256
CASES = ("rademacher s64", "gaussian s96", "rademacher s41")


def _kernel(dtype):
    kw = {"device": "cpu", "dtype": dtype}
    return gt.se(3.0, 5.5, **kw) + gt.white(0.5, **kw)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(x, alpha, u, z) in float32 with u = K^-1 z solved in float64
    (numpy: K of SE(3, 5.5) + White(0.5) + 1e-3 I)."""
    kind, s = name.split()
    s = int(s[1:])
    rng = np.random.default_rng(s)
    x = np.sort(rng.uniform(-10.0, 10.0, size=(N, 1)), axis=0)
    if kind == "rademacher":
        z = rng.integers(0, 2, size=(N, s)) * 2.0 - 1.0
    else:
        z = rng.normal(size=(N, s))
    k = 3.0 * np.exp(-((x - x.T) / 5.5) ** 2) + (0.5 + 1e-3) * np.eye(N)
    u = np.linalg.solve(k, z)
    alpha = rng.normal(size=N) * 0.1
    return tuple(torch.as_tensor(t, dtype=torch.float32) for t in (x, alpha, u, z))


def _want(u, z):
    """what in float64 and its sum of |terms|."""
    u, z = u.double(), z.double()
    c = 0.5 / z.shape[1]
    return ((u @ z.T + z @ u.T) * c,
            (u.abs() @ z.abs().T + z.abs() @ u.abs().T) * c)


def _worst_ulps(got, want, scale):
    return float(((got.double() - want).abs() / scale).max()) / EPS32


@pytest.mark.parametrize("name", CASES)
def test_probe_tf32x3_within_four_ulps(name):
    _, _, u, z = _case(name)
    got = clg.probe_what_tf32x3(u, z)
    assert got.dtype == torch.float32 and got.shape == (N, N)
    assert _worst_ulps(got, *_want(u, z)) <= ULPS


@pytest.mark.parametrize("name", CASES)
def test_probe_one_pass_lands_far_outside(name):
    """hi*hi alone carries 2^-11 of each product: at least 10 times the
    limit, so the checks on the card tell 1 pass from 3."""
    _, _, u, z = _case(name)
    got = clg.probe_what_tf32x3(u, z, passes=1)
    assert _worst_ulps(got, *_want(u, z)) >= 10.0 * ULPS


def _term_scales(kernel, x, alpha, what):
    """sum |W_ij dk_ij/dtheta_p| per hyperparameter, then the sums of
    |terms| of tr(W_hat K) and tr(W_hat) (chip_smoke.py's _term_scales)."""
    w = 0.5 * (torch.outer(alpha, alpha) - what)
    r2 = sq_distances(x)
    out = [float(torch.sum((w * dk).abs())) for dk in term_derivatives(kernel, r2)]
    out.append(float(torch.sum((what * kernel.evaluate_r2(r2)).abs())))
    out.append(float(torch.sum(torch.diagonal(what).abs())))
    return out


def _flat(res):
    d_kernel, traces, *sdot = res
    return [float(t) for t in (*gt.params.leaves(d_kernel), *traces,
                               *(sdot[0] if sdot else ()))]


@pytest.mark.parametrize("name", CASES)
def test_split_contraction_meets_reference(name):
    """The contraction of the plain TF32 estimate (in float64) against the
    float64 reference: each output within 4 f32 ulps of its sum of |terms|
    and 1e-2 of its value, as _hold holds the kernel."""
    x, alpha, u, z = (t.double() for t in _case(name))
    k64 = _kernel(torch.float64)
    got = _flat(clg.logml_probe_grads_tf32x3(k64, x, alpha, u.float(), z.float()))
    want = _flat(clg.logml_probe_grads_reference(k64, x, alpha, u, z))
    what = _want(u, z)[0]
    for g, w, sc in zip(got, want, _term_scales(k64, x, alpha, what)):
        assert abs(g - w) <= min(ULPS * EPS32 * sc, 1e-2 * abs(w))


def test_split_contraction_ard():
    """The ARD leg (Matern 5/2 + White, D = 3, ragged s = 41): the sums
    sdot too, within 4 f32 ulps of their sums of |terms|."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(-3.0, 3.0, size=(N, 3)))
    kw = {"device": "cpu", "dtype": torch.float64}
    kern = gt.matern(1.0, 2.5, 2.0, **kw) + gt.white(0.25, **kw)
    k = kern.evaluate_xx(x, x, sq_distances(x)) + 1e-3 * torch.eye(N, dtype=torch.float64)
    z = torch.as_tensor(rng.integers(0, 2, size=(N, 41)) * 2.0 - 1.0)
    u = torch.linalg.solve(k, z).float().double()
    alpha = torch.as_tensor(rng.normal(size=N) * 0.1)
    got = _flat(clg.logml_probe_grads_tf32x3(kern, x, alpha, u.float(), z.float(),
                                             ard=True))
    want = _flat(clg.logml_probe_grads_reference(kern, x, alpha, u, z, ard=True))
    what = _want(u, z)[0]
    w = 0.5 * (torch.outer(alpha, alpha) - what)
    r2 = sq_distances(x)
    wk = w.abs() * term_dr2(kern, r2, absolute=True)
    scales = _term_scales(kern, x, alpha, what) + [
        float(torch.sum(wk * (x[:, e, None] - x[None, :, e]) ** 2)) for e in range(3)]
    assert len(got) == len(want) == len(scales) == 8
    for g, v, sc in zip(got, want, scales):
        assert abs(g - v) <= ULPS * EPS32 * sc
