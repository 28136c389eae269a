"""The CUDA matvec's arithmetic on the CPU: its plain TF32 version
(``_gram_matvec_tf32x3_torch``, ``_cross_matvec_tf32x3_torch``: every K
entry and V split into TF32 hi/lo, the four products lo*lo + lo*hi + hi*lo
+ hi*hi, each 64-point slab rounded to float32) against the float64 plain
route, within the limit ``chip_smoke.py`` holds the kernel to on the card:
4 float32 ulps of each output's sum of |terms|. A 1-pass version (hi*hi
alone) lands far outside it. The float64 plain route is held against the
JAX package in ``test_torch_iterative.py``."""

import functools

import numpy as np
import pytest
import torch

import gpx_torch as gt
from gpx_torch.ops import cuda_matvec as cm

EPS32 = 2.0 ** -23
ULPS = 4.0        # chip_smoke.py: _matvec_checks' limit
NUGGET = 1e-3
N = 700           # neither a multiple of 16 nor of the 64-point slab


def _kernel(name, dtype):
    kw = {"device": "cpu", "dtype": dtype}
    white = gt.white(0.5, **kw)
    if name == "se+white":
        return gt.se(2.0, 3.0, **kw) + white
    if name == "matern32+white":
        return gt.matern(2.0, 1.5, 3.0, **kw) + white
    return gt.se(2.0, 3.0, **kw) * gt.periodic(1.0, 2.5, 4.0, **kw) + white


def _points(rng, n, d):
    """Centred float32 points: D = 1 sorted on [-10, 10]; D = 12 standard
    normal with its last quarter duplicating its first."""
    if d == 1:
        x = np.sort(rng.uniform(-10.0, 10.0, size=(n, 1)), axis=0)
    else:
        x = rng.normal(size=(n, d))
        x[n - n // 4:] = x[:n // 4]
    x = torch.as_tensor(x, dtype=torch.float32)
    return x - x.mean(dim=0, keepdim=True)


def _worst_ulps(got, want, scale):
    return float(((got.double() - want).abs() / scale).max()) / EPS32


FAMILIES = ("se+white", "matern32+white", "se*periodic+white")
WIDTHS = (1, 9, 40)


@functools.lru_cache(maxsize=None)
def _gram_case(name, d):
    """One call of each version per kernel and D, on V = [V_1 | V_9 | V_40]
    (columns are independent): the float64 result and its sum of |terms|,
    the kernel's TF32 version and, at D = 1, the 1-pass one."""
    rng = np.random.default_rng(11 * d)
    x = _points(rng, N, d)
    v = torch.as_tensor(rng.normal(size=(N, sum(WIDTHS))), dtype=torch.float32)
    k64, k32 = _kernel(name, torch.float64), _kernel(name, torch.float32)
    both = cm._gram_matvec_torch(k64, x.double(),
                                 torch.cat([v, v.abs()], dim=1).double(), NUGGET)
    want, scale = both.split(v.shape[1], dim=1)
    return {passes: (cm._gram_matvec_tf32x3_torch(k32, x, v, NUGGET,
                                                  passes=passes), want, scale)
            for passes in ((4, 1) if d == 1 else (4,))}


def _columns(r):
    c0 = sum(WIDTHS[:WIDTHS.index(r)])
    return slice(c0, c0 + r)


@pytest.mark.parametrize("r", WIDTHS)
@pytest.mark.parametrize("d", [1, 12])
@pytest.mark.parametrize("name", FAMILIES)
def test_gram_tf32x3_within_four_ulps(name, d, r):
    got, want, scale = (t[:, _columns(r)] for t in _gram_case(name, d)[4])
    assert _worst_ulps(got, want, scale) <= ULPS


@pytest.mark.parametrize("name", FAMILIES)
def test_cross_tf32x3_within_four_ulps(name):
    """D = 2, 300 x 701 points with 60 duplicates across the sets (White
    fires on them), R = 9."""
    rng = np.random.default_rng(5)
    x2 = rng.uniform(-10.0, 10.0, size=(701, 2))
    x1 = np.concatenate([x2[:60], rng.uniform(-10.0, 10.0, size=(240, 2))])
    c = x2.mean(axis=0, keepdims=True)
    x1 = torch.as_tensor(x1 - c, dtype=torch.float32)
    x2 = torch.as_tensor(x2 - c, dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(701, 9)), dtype=torch.float32)
    k64 = _kernel(name, torch.float64)
    want = cm._cross_matvec_torch(k64, x1.double(), x2.double(), v.double())
    scale = cm._cross_matvec_torch(k64, x1.double(), x2.double(),
                                   v.double().abs())
    got = cm._cross_matvec_tf32x3_torch(_kernel(name, torch.float32), x1, x2, v)
    assert _worst_ulps(got, want, scale) <= ULPS


@pytest.mark.parametrize("name", FAMILIES)
def test_one_pass_lands_far_outside(name):
    """hi*hi alone carries 2^-11 of each product: at least 10 times the
    limit (D = 1, R = 9), so the check on the card tells 1 pass from 3."""
    got, want, scale = (t[:, _columns(9)] for t in _gram_case(name, 1)[1])
    assert _worst_ulps(got, want, scale) >= 10.0 * ULPS


def test_tf32_split_rounds_to_nearest():
    """hi and lo hold 11 significant bits (the low 13 bits clear), hi is
    the nearest TF32 value, and hi + lo is within 2^-22 of the input."""
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.normal(size=4096) * 10.0 ** rng.uniform(-6, 6, 4096),
                        dtype=torch.float32)
    hi, lo = cm.tf32_split(a)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    a64, hi64 = a.double(), hi.double()
    assert bool(((a64 - hi64).abs() <= 2.0 ** -11 * a64.abs()).all())
    assert bool(((a64 - hi64 - lo.double()).abs() <= 2.0 ** -22 * a64.abs()).all())
