"""Products of Sums in the CUDA term table, against autograd and the JAX
package on the CPU: the table's expansion (values, derivatives and dK/dr2 in
their plain form) against autograd of ``evaluate_r2``, the gate by the
expansion's size, the leaves' order against gpx's, and F3 through the fused
composition and the hybrid (the plain versions of their kernels) against
gpx in float64.

F3 is ``(se(2, 3) + matern(1, 3/2, 2)) * periodic(1, 2.5, 1.5) +
white(0.1)``: SE Per + M3/2 Per + White, 5 table rows in 3 products over 8
hyperparameters, Periodic's three in two products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.models import gp as jgp
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy
from gpx_torch.kernels import expanded_size
from gpx_torch.models import gp
from gpx_torch.ops import terms
from gpx_torch.ops.distance import sq_distances

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
ELL = [0.7, 2.3, 1.4]
N = 150  # pads to 256 at the fused route's tiles
# gpx's oracles are one jitted program, compiled for compile time: on one
# core, LLVM at -O0 without fusion emitters (tests/test_torch_iterative.py)
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


def _f3(m, **kw):
    return ((m.se(2.0, 3.0, **kw) + m.matern(1.0, 1.5, 2.0, **kw))
            * m.periodic(1.0, 2.5, 1.5, **kw) + m.white(0.1, **kw))


def _kernel(name):
    if name == "F3":
        return _f3(gt, **F64)
    if name == "se+white*periodic":
        return gt.Product((gt.se(1.5, 2.0, **F64) + gt.white(0.3, **F64),
                           gt.periodic(0.8, 3.1, 1.4, **F64)))
    # nested: ((se + rq) * matern + se) * periodic, 8 rows in 3 products
    return gt.Product((
        gt.Product((gt.se(1.2, 2.5, **F64)
                    + gt.rational_quadratic(0.9, 0.7, 1.9, **F64),
                    gt.matern(1.1, 2.5, 3.0, **F64)))
        + gt.se(0.6, 4.0, **F64),
        gt.periodic(1.0, 2.9, 1.7, **F64)))


def _jacobian(fn, kern):
    return torch.autograd.functional.jacobian(
        lambda *ls: fn(tparams.unflatten(kern, ls)), tuple(tparams.leaves(kern)))


@pytest.mark.parametrize("name", ["F3", "ArdF3", "se+white*periodic", "nested"])
def test_product_of_sums_table_matches_autograd(name):
    """``term_values``, ``term_derivatives`` (a leaf in several products
    sums its products' terms) and ``term_dr2`` against autograd of
    ``evaluate_r2``, with r2 == 0 entries, to 1e-10 relative. ArdF3: the
    base's table on the scaled distances, and dK/d ell_e = dK/dr2 * -2
    (x_ie - x_je)^2 / ell_e^3 against autograd of the Ard kernel's Gram."""
    rng = np.random.default_rng(1)
    tol = dict(rtol=1e-10, atol=1e-14)
    if name == "ArdF3":
        kern = gt.ard(_f3(gt, **F64), ELL, **F64)
        x = torch.as_tensor(rng.uniform(-3.0, 3.0, (12, 3)))
        x[5] = x[2]  # a coincident pair: White fires off the diagonal
        ell = kern.ell
        r2 = sq_distances(x / ell)
        base = kern.base
        jac = _jacobian(lambda k: k.evaluate_xx(x, x, None), kern)
        np.testing.assert_allclose(terms.term_values(base, r2).numpy(),
                                   kern.evaluate_xx(x, x, None).numpy(), **tol)
        got = terms.term_derivatives(base, r2)
        dr2 = terms.term_dr2(base, r2)
        diff2 = (x[:, None, :] - x[None, :, :]) ** 2
        got.append(dr2[..., None] * -2.0 * diff2 / ell ** 3)
        assert len(got) == len(jac) == 9
        for g, w in zip(got, jac):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **tol)
        return
    kern = _kernel(name)
    assert kern.cuda_supported
    r2 = torch.as_tensor(np.concatenate([[0.0, 0.0],
                                         rng.uniform(0.01, 30.0, 40)]))
    np.testing.assert_allclose(terms.term_values(kern, r2).numpy(),
                               kern.evaluate_r2(r2).numpy(), **tol)
    jac = _jacobian(lambda k: k.evaluate_r2(r2), kern)
    got = terms.term_derivatives(kern, r2)
    assert len(got) == len(jac) == len(tparams.leaves(kern))
    for g, w in zip(got, jac):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **tol)
    r2g = r2.clone().requires_grad_()
    (want,) = torch.autograd.grad(kern.evaluate_r2(r2g).sum(), r2g)
    np.testing.assert_allclose(terms.term_dr2(kern, r2).numpy(), want.numpy(),
                               **tol)


def test_f3_table_rows_repeat_the_shared_leaf():
    """F3's table: 5 rows in 3 products, Periodic's offset (4) in two of
    them; the parameters unexpanded, in leaves order."""
    table, params = terms.table_tensors(_f3(gt, device="cpu",
                                            dtype=torch.float32), "cpu")
    rows = table.reshape(-1, terms.COLS).tolist()
    assert rows == [[terms.SE, 0, 0, 0], [terms.PERIODIC, 4, 0, 0],
                    [terms.MATERN, 2, 1, 1], [terms.PERIODIC, 4, 0, 1],
                    [terms.WHITE, 7, 0, 2]]
    np.testing.assert_allclose(params.numpy(),
                               [2.0, 3.0, 1.0, 2.0, 1.0, 2.5, 1.5, 0.1],
                               rtol=1e-7)


@pytest.mark.parametrize("name, size, fits", [
    ("F3", (3, 5), True),
    ("se+white*periodic", (2, 4), True),
    ("nested", (3, 8), True),
    ("eight_factors", (1, 8), True),
    ("past_the_table", (8, 24), False),
    ("nine_factors", (1, 9), False),
])
def test_cuda_supported_by_expansion(name, size, fits):
    """``cuda_supported`` is true for an expansion of at most 8 factors and
    false past it, counted without expanding; the table raises past it."""
    se = gt.se(1.0, 2.0, **F64)
    kern = {
        "eight_factors": lambda: gt.Product((se,) * 8),
        "nine_factors": lambda: gt.Product((se,) * 9),
        "past_the_table": lambda: gt.Product((
            se + gt.matern(1.0, 1.5, 2.0, **F64),
            gt.periodic(1.0, 2.0, 1.0, **F64)
            + gt.rational_quadratic(1.0, 0.7, 1.0, **F64),
            se + gt.white(0.1, **F64))),
    }.get(name, lambda: _f3(gt, **F64) if name == "F3" else _kernel(name))()
    assert expanded_size(kern) == size
    assert kern.cuda_supported is fits
    assert gt.ard(kern, [1.0], **F64).cuda_supported is False
    if fits:
        assert len(terms._rows(kern)) == size[1]
    else:
        with pytest.raises(ValueError, match="more than 8"):
            terms.table_tensors(kern, "cpu")


def test_f3_leaves_order_matches_gpx():
    """gpx's ``tree_leaves`` of F3 and Ard(F3) map one to one onto the
    port's leaves (names, values, and back)."""
    for jk, template in ((_f3(gpx), _f3(gt, **F64)),
                         (gpx.ard(_f3(gpx), ELL), gt.ard(_f3(gt, **F64),
                                                         [1.0] * 3, **F64))):
        jp = gpx.Parameters(mean=gpx.zero(), kernel=jk)
        tp = params_from_numpy(gt.Parameters(mean=gt.zero(), kernel=template),
                               jax.tree_util.tree_leaves(jp))
        assert tparams.names(tp) == gpx.params.names(jp)
        np.testing.assert_array_equal(tparams.to_array(tp).numpy(),
                                      np.asarray(gpx.params.to_array(jp)))


def _flat(value, grads):
    leaves = (tparams.leaves(grads) if isinstance(grads, torch.nn.Module)
              else jax.tree_util.tree_leaves(grads))
    return [float(value)] + [float(v) for g in leaves
                             for v in np.ravel(np.asarray(g))]


@pytest.fixture(scope="module")
def f3_case():
    """n = 150 points on D = 1 and D = 3, gpx's float64 analytic results
    for F3 and Ard(F3) and its hybrid for F3 on 16 probes, in one jitted
    program."""
    rng = np.random.default_rng(11)
    x1 = rng.uniform(-10.0, 10.0, (N, 1))
    x3 = rng.uniform(-3.0, 3.0, (N, 3))
    y = rng.normal(size=N)
    jk = {"F3": _f3(gpx), "ArdF3": gpx.ard(_f3(gpx), ELL)}
    key = jax.random.PRNGKey(5)
    z = jax.random.rademacher(key, (N, 16), jnp.float32)

    def oracle(ks, a1, a3, b):
        out = {name: jgp.logml_value_and_grad(
            gpx.Parameters(mean=gpx.zero(), kernel=k), a3 if name == "ArdF3"
            else a1, b) for name, k in ks.items()}
        out["hybrid"] = jgp._logml_value_and_grad_hybrid(
            gpx.Parameters(mean=gpx.zero(), kernel=ks["F3"]), a1, b,
            jgp.LOGML_NUGGET, probes=16, key=key, deflate=8, interpret=True)
        return out

    want = jax.jit(oracle, compiler_options=_FAST_COMPILE)(
        jk, jnp.asarray(x1), jnp.asarray(x3), jnp.asarray(y))
    return (x1, x3, y, jk, np.asarray(z, np.float64), want)


def _port_params(jk):
    template = _f3(gt, **F64)
    if isinstance(jk, gpx.kernels.Ard):
        template = gt.ard(template, [1.0] * 3, **F64)
    return params_from_numpy(gt.Parameters(mean=gt.zero(), kernel=template),
                             jax.tree_util.tree_leaves(
                                 gpx.Parameters(mean=gpx.zero(), kernel=jk)))


@pytest.mark.parametrize("name", ["F3", "ArdF3"])
def test_f3_fused_composition_matches_gpx(f3_case, name):
    """F3 (D = 1) and Ard(F3) (D = 3) through the fused composition, the
    plain versions of chol_inv and the gradient kernel on CPU tensors,
    padded from 150 to 256, against gpx's analytic logML and gradient in
    float64: value and every leaf, Periodic's included, to 1e-8
    relative."""
    x1, x3, y, jk, _, want = f3_case
    tp = _port_params(jk[name])
    x = torch.as_tensor(x3 if name == "ArdF3" else x1)
    yt = torch.as_tensor(y)
    k = gp.gram(tp.kernel, x, nugget=gp.LOGML_NUGGET)
    value, d_kernel, _ = gp._fused_logml_core(tp.kernel, x, yt, k,
                                              gp.LOGML_NUGGET)
    jv, jg = want[name]
    np.testing.assert_allclose(_flat(value, d_kernel), _flat(jv, jg.kernel),
                               rtol=1e-8)
    got = gp.logml_value_and_grad(tp, x, yt)
    np.testing.assert_allclose(_flat(got[0], got[1].kernel),
                               _flat(jv, jg.kernel), rtol=1e-8)


def test_f3_hybrid_matches_gpx_same_probes(f3_case):
    """F3 through the hybrid (deflated by 8) on gpx's own 16 probes
    against gpx's hybrid: the port runs the estimator in float64, gpx with
    chol_inv and the probe kernel in float32 inside, so the difference is
    gpx's f32 rounding; 1e-5 of the value and 5e-3 relative per gradient
    (test_torch_hybrid.py measured 5.3e-4 on a cancelling h)."""
    x1, _, y, jk, z, want = f3_case
    tp = _port_params(jk["F3"])
    got = gp._logml_value_and_grad_hybrid(
        tp, torch.as_tensor(x1), torch.as_tensor(y), gp.LOGML_NUGGET,
        z=torch.as_tensor(z), deflate=8)
    g, w = _flat(got[0], got[1].kernel), _flat(want["hybrid"][0],
                                                want["hybrid"][1].kernel)
    np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
    np.testing.assert_allclose(g[1:], w[1:], rtol=5e-3)
