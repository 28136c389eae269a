"""The port's hybrid gradient (``method="hybrid"``) against the JAX package,
on the CPU: the plain version of the probe kernel against gpx's Pallas
kernel (interpret mode), the path with identity probes against gpx's
autodiff in float64, the path against gpx's hybrid on the same probes, and
its pieces (pivoted Cholesky, the spine factorization and solves,
``split_noise``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.kernels import split_noise as jax_split_noise
from gpx.models import gp as jgp
from gpx.models.gp_iterative import pivoted_cholesky as jax_pivoted_cholesky
from gpx.ops.pallas_logml_grad import logml_probe_grads
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy
from gpx_torch.kernels import split_noise
from gpx_torch.models import gp
from gpx_torch.models.gp_iterative import pivoted_cholesky
from gpx_torch.ops import cuda_chol
from gpx_torch.ops.cuda_logml_grad import logml_probe_grads_reference

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
N = 290  # pads to 320 at base=64 (a 256 + 64 Schur split), 384 at LEAF


def _pair():
    jp = gpx.Parameters(mean=gpx.zero(), kernel=gpx.se(3.0, 5.5) + gpx.white(0.5))
    template = gt.Parameters(mean=gt.zero(), kernel=gt.se(1.0, 1.0, **F64)
                             + gt.white(1.0, **F64))
    return jp, params_from_numpy(template, jax.tree_util.tree_leaves(jp))


@pytest.fixture(scope="module")
def case():
    """n = 290 points, targets and gpx's float64 autodiff oracle (one
    jitted program for the module)."""
    rng = np.random.default_rng(42)
    x = rng.uniform(-10, 10, size=(N, 1))
    y = rng.normal(size=N)
    jp, tp = _pair()
    oracle = jax.jit(lambda p, a, b: jgp.logml_value_and_grad(
        p, a, b, method="autodiff"))(jp, jnp.asarray(x), jnp.asarray(y))
    return x, y, jp, tp, oracle


def _flat(value, grads):
    leaves = (tparams.leaves(grads) if isinstance(grads, torch.nn.Module)
              else jax.tree_util.tree_leaves(grads))
    return float(value), np.concatenate([np.ravel(np.asarray(g)) for g in leaves])


def test_probe_grads_reference_matches_pallas(rng):
    n, s = 256, 16
    x = rng.uniform(-10, 10, size=(n, 1))
    kern_j = gpx.se(1.0, 2.0) + gpx.white(0.5)
    k = np.exp(-(x - x.T) ** 2 / 4.0) + (0.5 + 1e-3) * np.eye(n)
    # targets of scale 3 keep every output far from a cancellation (as in
    # test_torch_logml_grad.py); u is the probe block's solve
    alpha = np.linalg.solve(k, 3.0 * rng.normal(size=n))
    z = rng.choice([-1.0, 1.0], size=(n, s))
    u = np.linalg.solve(k, z)
    want_k, (want_tkw, want_trw) = jax.jit(lambda *a: logml_probe_grads(
        kern_j, *a, bt=64, interpret=True, with_correction=True))(
        jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(u), jnp.asarray(z))
    kern = gt.se(1.0, 2.0, **F64) + gt.white(0.5, **F64)
    got_k, (got_tkw, got_trw) = logml_probe_grads_reference(
        kern, *(torch.as_tensor(a) for a in (x, alpha, u, z)))
    got = [float(t) for t in (*tparams.leaves(got_k), got_tkw, got_trw)]
    want = [float(t) for t in (*jax.tree_util.tree_leaves(want_k),
                               want_tkw, want_trw)]
    # gpx sums in f32 at bf16x3 (~1.5e-5 per dot)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("deflate", [0, 48])
def test_hybrid_identity_probes_match_gpx_autodiff(case, deflate):
    """With z = sqrt(n) I the Hutchinson estimate is exact (z z^T = n I),
    and so is the deflated split for any orthonormal basis: in float64
    the path meets gpx's autodiff to round-off. Uneven splits at
    base=64."""
    x, y, _, tp, (v_a, g_a) = case
    z = np.sqrt(N) * torch.eye(N, dtype=torch.float64)
    got = gp._logml_value_and_grad_hybrid(
        tp, torch.as_tensor(x), torch.as_tensor(y), gp.LOGML_NUGGET, z=z,
        deflate=deflate, base=64)
    (v, g), (vw, gw) = _flat(*got), _flat(v_a, g_a.kernel)
    np.testing.assert_allclose(v, vw, rtol=1e-8)
    np.testing.assert_allclose(g, gw, rtol=1e-8)


@pytest.mark.parametrize("deflate", [0, 48])
def test_hybrid_matches_gpx_same_probes(case, deflate):
    """The port's hybrid in float64 against gpx's (float32 inside: chol_inv
    and the probe kernel at bf16x3, f32 sums) on the probe block gpx draws
    itself. The port is the float64 result of the same estimator, so the
    difference is gpx's f32 rounding: measured 1.5e-6 of the value and up
    to 5.3e-4 relative on the h gradient (a cancellation: -0.93 from
    terms of order 1e2), 1.2e-4 on sigma and 1.4e-6 on White. Both runs
    take the same pivots: the deflated case would show it otherwise."""
    x, y, jp, tp, _ = case
    key = jax.random.PRNGKey(5)
    z = jax.random.rademacher(key, (N, 32), jnp.float32)
    want = jax.jit(lambda p, a, b: jgp._logml_value_and_grad_hybrid(
        p, a, b, jgp.LOGML_NUGGET, probes=32, key=key, deflate=deflate,
        interpret=True))(jp, jnp.asarray(x), jnp.asarray(y))
    got = gp._logml_value_and_grad_hybrid(
        tp, torch.as_tensor(x), torch.as_tensor(y), gp.LOGML_NUGGET,
        z=torch.as_tensor(np.asarray(z, np.float64)), deflate=deflate)
    (v, g), (vw, gw) = _flat(*got), _flat(want[0], want[1].kernel)
    np.testing.assert_allclose(v, vw, rtol=1e-5)
    np.testing.assert_allclose(g, gw, rtol=2e-3)


@pytest.mark.parametrize("which", ["se+white", "exhausted", "linear"])
def test_pivoted_cholesky_matches_gpx(rng, which):
    """float64, same pivots. "exhausted": a smooth kernel whose residual
    falls below the floor before ``rank``, so the last columns are zero;
    "linear": a non-stationary kernel (its diagonal and columns need the
    coordinates), of rank 3 at D = 2."""
    if which == "se+white":
        kj, kt = gpx.se(3.0, 5.5) + gpx.white(0.5), (
            gt.se(3.0, 5.5, **F64) + gt.white(0.5, **F64))
        x, rank = rng.uniform(-10, 10, size=(150, 2)), 24
    elif which == "exhausted":
        kj, kt = gpx.se(1.0, 30.0), gt.se(1.0, 30.0, **F64)
        x, rank = rng.uniform(-1, 1, size=(150, 1)), 16
    else:
        kj, kt = gpx.linear(0.7, 0.2), gt.linear(0.7, 0.2, **F64)
        x, rank = rng.uniform(-2, 2, size=(150, 2)), 5
    want = np.asarray(jax.jit(lambda a: jax_pivoted_cholesky(kj, a, rank))(
        jnp.asarray(x)))
    got = pivoted_cholesky(kt, torch.as_tensor(x), rank).numpy()
    if which != "se+white":
        assert not want[:, -1].any() and not got[:, -1].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_chol_inv_spine(rng):
    """n = 384 at base=64 splits 256 + 128, the 128 as 64 + 64: the spine
    skips M21 at the top level and in the Schur child only."""
    n = 384
    a = rng.normal(size=(n, n))
    a = torch.as_tensor(a @ a.T + n * np.eye(n))
    lf, mf = cuda_chol.chol_inv(a, base=64)
    ls, msp = cuda_chol.chol_inv(a, base=64, spine=True)
    assert torch.equal(ls, lf)
    skipped = torch.zeros(n, n, dtype=torch.bool)
    skipped[256:, :256] = True
    skipped[320:, 256:320] = True
    assert not msp[skipped].any() and mf[skipped].abs().min() > 0
    assert torch.equal(msp[~skipped], mf[~skipped])
    for b in (torch.as_tensor(rng.normal(size=n)),
              torch.as_tensor(rng.normal(size=(n, 5)))):
        bm = b.reshape(n, -1)
        for got, upper, t in (
                (cuda_chol.spine_solve_lower(ls, msp, b, base=64), False, lf),
                (cuda_chol.spine_solve_lower_t(ls, msp, b, base=64), True, lf.T)):
            want = torch.linalg.solve_triangular(t, bm, upper=upper)
            assert got.shape == b.shape
            np.testing.assert_allclose(got.reshape(n, -1).numpy(),
                                       want.numpy(), rtol=0, atol=1e-12)


def test_split_noise_matches_gpx():
    """Two top-level White terms sum into the noise; the White inside the
    Product stays in the smooth part."""
    kj = (gpx.se(3.0, 5.5) + gpx.white(0.5)
          + gpx.matern(0.7, 2.5, 2.0) * gpx.white(0.1) + gpx.white(0.25))
    kt = (gt.se(3.0, 5.5, **F64) + gt.white(0.5, **F64)
          + gt.matern(0.7, 2.5, 2.0, **F64) * gt.white(0.1, **F64)
          + gt.white(0.25, **F64))
    sj, nj = jax_split_noise(kj)
    st, nt = split_noise(kt)
    assert float(nt) == float(nj) == 0.75
    assert [float(t) for t in tparams.leaves(st)] == \
        [float(t) for t in jax.tree_util.tree_leaves(sj)]
    assert type(st).__name__ == type(sj).__name__ == "Sum"
    assert [type(k).__name__ for k in st.kernels] == \
        [type(k).__name__ for k in sj.kernels]
    assert split_noise(gt.white(0.5, **F64))[0] is None
    smooth, noise = split_noise(gt.se(1.0, 2.0, **F64))
    assert isinstance(smooth, gt.SquaredExponential) and float(noise) == 0.0


def test_hybrid_entry_is_deterministic_and_shaped(rng):
    """The public entry: a seeded generator gives the same result twice,
    the default generator (seed 0) likewise, and the gradient is a
    ``Parameters`` tree of the input's shape (mean included)."""
    n = 100
    x = torch.as_tensor(rng.uniform(-10, 10, size=(n, 2)))
    y = torch.as_tensor(rng.normal(size=n))
    tp = gt.Parameters(mean=gt.plane([0.1, -0.2, 0.3], **F64),
                       kernel=gt.se(3.0, 5.5, **F64) + gt.white(0.5, **F64))

    def run(key):
        return _flat(*gp.logml_value_and_grad(tp, x, y, method="hybrid",
                                              probes=16, probe_key=key))

    seeded = [run(torch.Generator().manual_seed(3)) for _ in range(2)]
    default = [run(None) for _ in range(2)]
    for a, b in (seeded, default):
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
        assert np.isfinite(a[0]) and np.all(np.isfinite(a[1]))
    _, grads = gp.logml_value_and_grad(tp, x, y, method="hybrid", probes=16)
    assert tparams.names(grads) == tparams.names(tp)
    assert [t.shape for t in tparams.leaves(grads)] == \
        [t.shape for t in tparams.leaves(tp)]


@pytest.mark.parametrize("kernel,error", [
    # one top-level Ard runs (tests/test_torch_families.py); two do not
    (lambda: gt.ard(gt.ard(gt.se(1.0, 1.0, **F64) + gt.white(0.5, **F64),
                           [0.5, 2.0], **F64), [1.0, 1.0], **F64), ValueError),
    (lambda: gt.linear(1.0, 0.5, **F64) + gt.white(0.5, **F64), ValueError),
    (lambda: gt.matern(1.0, 1.3, 2.0, **F64), ValueError),
], ids=["ard", "non-stationary", "not-pallas-safe"])
def test_hybrid_scope_raises(kernel, error):
    tp = gt.Parameters(mean=gt.zero(), kernel=kernel())
    x = torch.zeros(8, 2, dtype=torch.float64)
    with pytest.raises(error):
        gp.logml_value_and_grad(tp, x, torch.zeros(8, dtype=torch.float64),
                                method="hybrid")
