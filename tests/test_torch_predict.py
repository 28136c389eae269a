"""The prediction path and its helper ops against the JAX package, in
float64 on the CPU: ``fit`` on both routes (the fused composition on CPU
tensors runs the plain versions of its kernels), ``full_cov``, zero and
plane means, ``draw`` and ``posterior_draw`` held as ``mean + z L^T``, the
gradient noise floor off the fused route, and the distance, Cholesky and
Gram helpers. SE + White is the bench's kernel; F3 is ``(se(2, 3) +
matern(1, 3/2, 2)) * periodic(1, 2.5, 1.5) + white(0.1)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.models import gp as jgp
from gpx.ops import chol as jchol
from gpx.ops import distance as jdist
from gpx.ops.gram import build_cov_matrix as j_build_cov_matrix
from gpx.ops.gram import cross_gram as j_cross_gram
from gpx.ops.gram import gram as j_gram
from gpx.ops.gram import tangent_grams as j_tangent_grams
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy
from gpx_torch.models import gp
from gpx_torch.ops import chol, distance
from gpx_torch.ops import gram as tgram

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
N, M = 300, 70  # n is not a multiple of the fused route's 128
# one jitted program for gpx's oracles, compiled for compile time
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}
CASES = [("se+white", "zero"), ("se+white", "plane"), ("F3", "zero"),
         ("F3", "plane")]


def _kernel(m, name, **kw):
    if name == "F3":
        return ((m.se(2.0, 3.0, **kw) + m.matern(1.0, 1.5, 2.0, **kw))
                * m.periodic(1.0, 2.5, 1.5, **kw) + m.white(0.1, **kw))
    return m.se(3.0, 5.5, **kw) + m.white(0.5, **kw)


def _pair(name, mean):
    jm = gpx.plane([0.3, -0.2]) if mean == "plane" else gpx.zero()
    tm = gt.plane([0.0, 0.0], **F64) if mean == "plane" else gt.zero()
    jp = gpx.Parameters(mean=jm, kernel=_kernel(gpx, name))
    tp = params_from_numpy(gt.Parameters(mean=tm, kernel=_kernel(gt, name, **F64)),
                           jax.tree_util.tree_leaves(jp))
    return jp, tp


@pytest.fixture(scope="module")
def case():
    """x (300, 1), y, a 70-point test grid with one point on a training
    point (White fires there in K(x, xs)), and gpx's fits (marginal and full
    covariance) for every case, its prior factor for the draws and its
    posterior factor for ``posterior_draw``, in one program."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-10.0, 10.0, (N, 1))
    y = rng.normal(size=N)
    xs = np.linspace(-10.0, 10.0, M)[:, None]
    xs[9] = x[5]
    pairs = {c: _pair(*c) for c in CASES}

    x32 = x[:100].astype(np.float32).astype(np.float64)
    y32 = y[:100].astype(np.float32).astype(np.float64)

    def oracle(jps, a, b, s, a32, b32):
        out = {}
        for c, p in jps.items():
            summ = jgp.fit(p, a, b, s)
            mean, cov = jgp.fit(p, a, b, s, full_cov=True)
            out[c] = (summ.mean, summ.variance, mean, cov,
                      jchol.cholesky(p.kernel.gram(a, nugget=jgp.DRAW_NUGGET)),
                      jchol.cholesky(jchol.add_jitter(cov, 1e-8)))
        # the noise floor's float64 oracle, at float32-rounded inputs
        return out, jgp.logml_value_and_grad(jps[("F3", "plane")], a32, b32,
                                             method="autodiff")[1]

    want, g64 = jax.jit(oracle, compiler_options=_FAST_COMPILE)(
        {c: jp for c, (jp, _) in pairs.items()}, jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(xs), jnp.asarray(x32), jnp.asarray(y32))
    g64 = [np.asarray(t) for t in jax.tree_util.tree_leaves(g64)]
    return (torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(xs),
            {c: tp for c, (_, tp) in pairs.items()},
            {c: [np.asarray(t) for t in w] for c, w in want.items()}, g64)


@pytest.mark.parametrize("route", ["plain", "fused"])
@pytest.mark.parametrize("kern, mean", CASES)
def test_fit_matches_gpx(case, monkeypatch, kern, mean, route):
    """``fit``'s mean and variance against gpx's (its CPU route: Cholesky
    and triangular solves), to 1e-9 of the output's scale. "fused": the
    fused composition on CPU tensors (padded 300 -> 384, ``chol_inv``'s
    and trmm's plain versions, alpha through ``L^-1`` with two refinement
    steps)."""
    x, y, xs, tps, want, _ = case
    if route == "fused":
        monkeypatch.setattr(gp, "_fused_gate", lambda kernel, x_: True)
    summ = gp.fit(tps[(kern, mean)], x, y, xs)
    w_mean, w_var = want[(kern, mean)][:2]
    assert torch.equal(summ.x, xs)
    np.testing.assert_allclose(summ.mean.numpy(), w_mean, rtol=0,
                               atol=1e-9 * np.abs(w_mean).max())
    np.testing.assert_allclose(summ.variance.numpy(), w_var, rtol=0,
                               atol=1e-9 * np.abs(w_var).max())


@pytest.mark.parametrize("kern, mean", CASES)
def test_fit_full_cov_matches_gpx(case, kern, mean):
    """``full_cov=True``: the mean and ``K(xs, xs) - A^T A`` against gpx's,
    to 1e-9 of the scale; its diagonal is the marginal variance."""
    x, y, xs, tps, want, _ = case
    mean_t, cov = gp.fit(tps[(kern, mean)], x, y, xs, full_cov=True)
    w_mean, w_var, _, w_cov = want[(kern, mean)][:4]
    np.testing.assert_allclose(mean_t.numpy(), w_mean, rtol=0,
                               atol=1e-9 * np.abs(w_mean).max())
    np.testing.assert_allclose(cov.numpy(), w_cov, rtol=0,
                               atol=1e-9 * np.abs(w_cov).max())
    np.testing.assert_allclose(np.diagonal(cov.numpy()), w_var, rtol=0,
                               atol=1e-9 * np.abs(w_cov).max())


@pytest.mark.parametrize("kern", ["se+white", "F3"])
@pytest.mark.parametrize("what", ["draw", "posterior_draw"])
def test_draws_are_mean_plus_z_lt(case, kern, what):
    """A draw is ``mean + z L^T`` with ``z`` from the same generator seed
    and ``L`` gpx's Cholesky factor (of ``K + 1e-3 I`` for ``draw``, of the
    posterior covariance plus 1e-8 I for ``posterior_draw``), to 1e-9."""
    x, y, xs, tps, want, _ = case
    tp = tps[(kern, "plane")]
    _, _, w_mean, _, l_prior, l_post = want[(kern, "plane")]
    if what == "draw":
        got = gp.draw(torch.Generator().manual_seed(3), tp, x, shape=(2,))
        mu, lf = tp.mean(x).numpy(), l_prior
    else:
        got = gp.posterior_draw(torch.Generator().manual_seed(3), tp, x, y,
                                xs, shape=(2,))
        mu, lf = w_mean, l_post
    z = torch.randn((2, lf.shape[0]), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64).numpy()
    assert tuple(got.shape) == (2, lf.shape[0])
    np.testing.assert_allclose(got.numpy(), mu + z @ lf.T, rtol=0, atol=1e-9)


def test_predict_curves_and_intervals(case):
    """``predict`` and ``get_intervals`` against gpx's on the same
    posterior, ``sample_points`` sorted in range, and
    ``posterior_predictive_curves`` as the fits of gpx's row selection."""
    x, y, xs, tps, want, _ = case
    tp = tps[("se+white", "zero")]
    w_mean, w_var, _, w_cov = want[("se+white", "zero")][:4]
    summ = gp.fit(tp, x, y, xs)
    for g, w in zip(gp.predict(summ, 0.9),
                    jgp.predict(jgp.PosteriorSummary(xs.numpy(), w_mean, w_var),
                                0.9)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9)
    for g, w in zip(gp.get_intervals(torch.tensor(w_mean), torch.tensor(w_cov),
                                     0.9),
                    jgp.get_intervals(w_mean, w_cov, 0.9)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    pts = gp.sample_points(torch.Generator().manual_seed(0), -2.0, 3.0, 50)
    assert pts.shape == (50,) and bool((pts[1:] >= pts[:-1]).all())
    assert float(pts.min()) >= -2.0 and float(pts.max()) <= 3.0
    flat = np.exp(np.random.default_rng(2).normal(size=(2, 5, 3)))
    curves = gp.posterior_predictive_curves(flat, tp, x, y, xs, n_curves=4)
    rows = flat.reshape(-1, 3)[::2][:4]  # gpx: take = max(1, 10 // 4)
    assert curves.shape == (4, M)
    for c, row in zip(curves, rows):
        p = gp.from_array_params(tp, torch.as_tensor(row))
        np.testing.assert_array_equal(c.numpy(), gp.fit(p, x, y, xs).mean.numpy())


def test_noise_floor_off_the_fused_route(case):
    """Off the fused route (CPU tensors) the floor is the measured
    ``|g32 - g64|`` against float64 autograd: held against gpx's float64
    autodiff gradient, and ``flagged = |g| < 10 floor``."""
    x, y, _, tps, _, g64 = case
    tp = tps[("F3", "plane")]
    x32, y32 = x[:100].float(), y[:100].float()
    tp32 = tparams.unflatten(tp, [t.float() for t in tparams.leaves(tp)])
    g, floor, flagged = gp.logml_gradient_noise_floor(tp32, x32, y32)
    want = [np.abs(a.numpy() - b.astype(np.float32))
            for a, b in zip(tparams.leaves(g), g64)]
    for f, w, gl, fl in zip(tparams.leaves(floor), want, tparams.leaves(g),
                            tparams.leaves(flagged)):
        np.testing.assert_allclose(f.numpy(), w, rtol=0, atol=1e-6 * (1 + np.abs(w).max()))
        assert torch.equal(fl, gl.abs() < 10.0 * f)


def _spd(rng, n):
    a = rng.normal(size=(n, n))
    return a @ a.T / n + np.eye(n)


def _helper(name, rng):
    """``(port result, gpx's function, its arguments)`` for one helper op
    on the same inputs."""
    x1, x2 = rng.uniform(-3, 3, (40, 2)), rng.uniform(-3, 3, (30, 2))
    x2[4] = x1[7] + 5e-4  # within the 1e-3 tolerance
    t1, t2 = torch.as_tensor(x1), torch.as_tensor(x2)
    k = _spd(rng, 300)
    l = np.linalg.cholesky(k)
    lt = torch.as_tensor(l)
    b = rng.normal(size=(300, 3))
    kj, kt = _kernel(gpx, "F3"), _kernel(gt, "F3", **F64)
    ka, kb, kab = k[:5, :5], k[5:9, 5:9], k[:5, 5:9]
    return {
        "distances": lambda: (distance.distances(t1, t2), jdist.distances,
                              (x1, x2)),
        "euclidean": lambda: (distance.euclidean(t1[0], t2[1]),
                              jdist.euclidean, (x1[0], x2[1])),
        "locations_close": lambda: (distance.locations_close(t1, t2),
                                    jdist.locations_close, (x1, x2)),
        "match_locations": lambda: (distance.match_locations(t1, t2),
                                    jdist.match_locations, (x1, x2)),
        "cho_solve": lambda: (chol.cho_solve(lt, torch.as_tensor(b)),
                              jchol.cho_solve, (l, b)),
        "tri_inverse_lower": lambda: (
            chol.tri_inverse_lower(lt, base=64),
            lambda a: jchol.tri_inverse_lower(a, base=64), (l,)),
        "spd_inverse_from_chol": lambda: (
            chol.spd_inverse_from_chol(lt, base=64),
            lambda a: jchol.spd_inverse_from_chol(a, base=64), (l,)),
        "add_jitter": lambda: (chol.add_jitter(torch.as_tensor(k), 1e-3),
                               lambda a: jchol.add_jitter(a, 1e-3), (k,)),
        "gram_xla": lambda: (kt.gram(t1, nugget=1e-3, method="xla"),
                             lambda a: j_gram(kj, a, nugget=1e-3, method="xla"),
                             (x1,)),
        "gram_pallas": lambda: (kt.gram(t1, nugget=1e-3, method="pallas"),
                                lambda a: j_gram(kj, a, nugget=1e-3,
                                                 method="xla"), (x1,)),
        "cross_gram": lambda: (tgram.cross_gram(kt, t1, t2),
                               lambda a, c: j_cross_gram(kj, a, c), (x1, x2)),
        "tangent_grams": lambda: (
            torch.stack(tparams.leaves(tgram.tangent_grams(kt, t1[:, :1]))),
            lambda a: jnp.stack(jax.tree_util.tree_leaves(
                j_tangent_grams(kj, a, method="xla"))), (x1[:, :1],)),
        "build_cov_matrix": lambda: (
            tgram.build_cov_matrix(*(torch.as_tensor(a) for a in (ka, kb, kab))),
            j_build_cov_matrix, (ka, kb, kab)),
    }[name]()


@pytest.mark.parametrize("name", [
    "distances", "euclidean", "locations_close", "match_locations",
    "cho_solve", "tri_inverse_lower", "spd_inverse_from_chol", "add_jitter",
    "gram_xla", "gram_pallas", "cross_gram", "tangent_grams",
    "build_cov_matrix"])
def test_helper_ops_match_gpx(name):
    """Each helper against gpx's on the same float64 inputs: to 1e-10 of the
    output's scale (exactly for masks and indices). ``gram_pallas`` is
    the CUDA kernel's entry, which takes its plain version on CPU tensors;
    ``tangent_grams`` F3's eight leaves by forward mode."""
    got, fn, args = _helper(name, np.random.default_rng(4))
    want = jax.jit(fn, compiler_options=_FAST_COMPILE)(
        *(jnp.asarray(a) for a in args))
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
        assert got.any()
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-10 * max(1.0, np.abs(want).max()))
