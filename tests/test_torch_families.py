"""The kernel families the CUDA term table holds beyond SE and White
(Matérn with half-integer nu, RQ, Periodic, Products) and the ARD leg of
the gradient kernels, against the JAX package on the CPU: the device
functions' formulas (in their plain form) against autograd, the plain Gram
against gpx's, the plain ARD gradient against gpx's Pallas kernel in
interpret mode, and the exact path and the hybrid in float64.

F1 is gpx's own test kernel SE(2, 3) * Matern(1, 5/2, 4) + White(0.1);
F2 its ARD case Ard(Matern(2, 5/2, 1) + White(0.25), [0.7, 2.3, 1.4])
(tests/test_pallas_grad.py)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.models import gp as jgp
from gpx.ops.pallas_logml_grad import logml_kernel_grads as jax_logml_kernel_grads
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy
from gpx_torch.models import gp
from gpx_torch.ops import cuda_logml_grad, terms
from gpx_torch.ops.cuda_gram import gram_reference

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
ELL = [0.7, 2.3, 1.4]
FAMILIES = ["matern12", "matern32", "matern52", "matern72", "rq", "periodic",
            "se*periodic"]


def _kernel(m, name):
    """The named kernel in package ``m`` (gpx, or the port in float64 on the
    CPU): a family plus White(0.1), or F1, or F2."""
    kw = {} if m is gpx else F64
    if name == "F2":
        return m.ard(m.matern(2.0, 2.5, 1.0, **kw) + m.white(0.25, **kw), ELL,
                     **kw)
    base = {
        "matern12": lambda: m.matern(1.3, 0.5, 2.0, **kw),
        "matern32": lambda: m.matern(1.3, 1.5, 2.0, **kw),
        "matern52": lambda: m.matern(1.3, 2.5, 2.0, **kw),
        "matern72": lambda: m.matern(1.3, 3.5, 2.0, **kw),
        "rq": lambda: m.rational_quadratic(1.2, 0.7, 1.9, **kw),
        "periodic": lambda: m.periodic(0.8, 3.1, 1.4, **kw),
        "se*periodic": lambda: m.se(2.0, 3.0, **kw) * m.periodic(
            1.0, 2.5, 4.0, **kw),
        "F1": lambda: m.se(2.0, 3.0, **kw) * m.matern(1.0, 2.5, 4.0, **kw),
    }[name]()
    return base + m.white(0.1, **kw)


def _data(name, n, seed=0):
    rng = np.random.default_rng(seed)
    d = 3 if name == "F2" else 1
    return rng.uniform(-10.0, 10.0, size=(n, d)), rng.normal(size=n)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_device_functions_match_autograd(name):
    """``term_derivatives`` (dK/dtheta, product rule included) and
    ``term_dr2`` (dK/dr2) against torch autograd of ``evaluate_r2``, with
    r2 == 0 entries; the table row carries Matérn's p and the groups."""
    kern = _kernel(gt, name)
    assert kern.cuda_supported
    r2 = torch.as_tensor(np.concatenate(
        [[0.0, 0.0], np.random.default_rng(1).uniform(0.01, 30.0, 40)]))
    jac = torch.autograd.functional.jacobian(
        lambda *ls: tparams.unflatten(kern, ls).evaluate_r2(r2),
        tuple(tparams.leaves(kern)))
    got = terms.term_derivatives(kern, r2)
    assert len(got) == len(jac) == len(tparams.leaves(kern))
    for g, w in zip(got, jac):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-14)
    r2g = r2.clone().requires_grad_()
    (want,) = torch.autograd.grad(kern.evaluate_r2(r2g).sum(), r2g)
    np.testing.assert_allclose(terms.term_dr2(kern, r2).numpy(), want.numpy(),
                               rtol=1e-10, atol=1e-14)
    table, _ = terms.table_tensors(kern, "cpu")
    rows = table.reshape(-1, terms.COLS).tolist()
    if name.startswith("matern"):
        assert rows[0] == [terms.MATERN, 0, int(name[6]) // 2, 0]
    assert [r[3] for r in rows] == ([0, 0, 1] if name == "se*periodic"
                                    else [0, 1])


@pytest.mark.parametrize("name", FAMILIES + ["F1", "F2"])
def test_gram_reference_matches_gpx(name):
    x, _ = _data(name, 64)
    x[-4:] = x[:4]  # duplicates: White fires off the diagonal too
    want = np.asarray(_kernel(gpx, name).gram(jnp.asarray(x), nugget=1e-3,
                                              method="xla"))
    got = gram_reference(_kernel(gt, name), torch.as_tensor(x), None, 1e-3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def _alpha_l_inv(kernel, x, y):
    k = gram_reference(kernel, x, None, gp.LOGML_NUGGET)
    l = torch.linalg.cholesky(k)
    l_inv = torch.linalg.solve_triangular(l, torch.eye(k.shape[0], **F64),
                                          upper=False)
    return l_inv.T @ (l_inv @ y), l_inv


@pytest.mark.parametrize("name", ["F1", "F2"])
def test_ard_grads_reference_matches_pallas(name):
    """The plain ARD leg (``sdot`` by autograd in r2) and the other outputs
    against gpx's Pallas kernel in interpret mode on the same float64
    inputs (gpx sums in f32: its tests' 1e-2 relative). F1 runs as the
    base of an Ard over the same three lengthscales."""
    x, y = _data("F2", 128)
    x, y = torch.as_tensor(x), 3.0 * torch.as_tensor(y)
    kern = _kernel(gt, name)
    if name == "F1":
        kern = gt.ard(kern, ELL, **F64)
    alpha, l_inv = _alpha_l_inv(kern, x, y)
    ell = torch.as_tensor(ELL, dtype=torch.float64)
    got_k, (tkw, trw), sdot = cuda_logml_grad.logml_kernel_grads(
        kern.base, x / ell, alpha, l_inv, ard=True)
    jbase = _kernel(gpx, name)
    jbase = jbase.base if name == "F2" else jbase
    want_k, (wtkw, wtrw), wsdot = jax_logml_kernel_grads(
        jbase, jnp.asarray((x / ell).numpy()), jnp.asarray(alpha.numpy()),
        jnp.asarray(l_inv.numpy()), bt=64, interpret=True,
        with_correction=True, ard=True)
    np.testing.assert_allclose(sdot.numpy(), np.asarray(wsdot), rtol=1e-2)
    got = [float(t) for t in (*tparams.leaves(got_k), tkw, trw)]
    want = [float(t) for t in (*jax.tree_util.tree_leaves(want_k), wtkw, wtrw)]
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-3)


def _pair(name):
    """gpx's and the port's Parameters for the named kernel, the port's
    carried across from gpx's leaves."""
    jp = gpx.Parameters(mean=gpx.zero(), kernel=_kernel(gpx, name))
    tp = params_from_numpy(gt.Parameters(mean=gt.zero(), kernel=_kernel(gt, name)),
                           jax.tree_util.tree_leaves(jp))
    return jp, tp


def _flat(value, grads):
    leaves = (tparams.leaves(grads) if isinstance(grads, torch.nn.Module)
              else jax.tree_util.tree_leaves(grads))
    return [float(value)] + [float(v) for g in leaves
                             for v in np.ravel(np.asarray(g))]


@pytest.fixture(scope="module")
def f64_cases():
    """n = 100 (the fused core pads it to 128): data and gpx's float64
    autodiff oracle for F1 and F2, one jitted program for both."""
    cases = {name: (_pair(name), *_data(name, 100, seed=3)) for name in ("F1", "F2")}
    oracle = jax.jit(lambda args: {
        name: jgp.logml_value_and_grad(p, jnp.asarray(a), jnp.asarray(b),
                                       method="autodiff")
        for name, (p, a, b) in args.items()})(
        {name: (jp, x, y) for name, ((jp, _), x, y) in cases.items()})
    return {name: (tp, torch.as_tensor(x), torch.as_tensor(y), oracle[name])
            for name, ((_, tp), x, y) in cases.items()}


@pytest.mark.parametrize("name", ["F1", "F2"])
def test_exact_path_matches_gpx_f64(f64_cases, name):
    """The analytic route and the fused core (the plain versions of its
    kernels, padded to 128; for F2 the ARD leg) against gpx's autodiff in
    float64: to round-off, value and every gradient leaf."""
    tp, x, y, (jv, jg) = f64_cases[name]
    want = _flat(jv, jg.kernel)
    got = gp.logml_value_and_grad(tp, x, y)
    np.testing.assert_allclose(_flat(got[0], got[1].kernel), want, rtol=1e-8)
    k = gp.gram(tp.kernel, x, nugget=gp.LOGML_NUGGET)
    value, d_kernel, _ = gp._fused_logml_core(tp.kernel, x, y, k,
                                              gp.LOGML_NUGGET)
    assert type(d_kernel) is type(tp.kernel)
    np.testing.assert_allclose(_flat(value, d_kernel), want, rtol=1e-8)


@pytest.mark.parametrize("deflate", [0, 16])
def test_hybrid_ard_identity_probes_exact(f64_cases, deflate):
    """F2 through the hybrid with z = sqrt(n) I (the estimate is then
    exact, deflated or not) against the analytic path, in float64."""
    tp, x, y, _ = f64_cases["F2"]
    n = x.shape[0]
    z = np.sqrt(n) * torch.eye(n, dtype=torch.float64)
    got = gp._logml_value_and_grad_hybrid(tp, x, y, gp.LOGML_NUGGET, z=z,
                                          deflate=deflate, base=64)
    want = gp.logml_value_and_grad(tp, x, y)
    np.testing.assert_allclose(_flat(got[0], got[1].kernel),
                               _flat(want[0], want[1].kernel), rtol=1e-8)


@pytest.mark.parametrize("name", FAMILIES)
def test_hybrid_identity_probes_exact_per_family(name):
    """Each family through the hybrid with z = sqrt(n) I, deflated by the
    pivoted Cholesky of its smooth part, against the analytic path in
    float64: the estimator is then exact, so any family's leg of the probe
    contraction or the deflation that is wrong shows."""
    x, y = (torch.as_tensor(a) for a in _data(name, 100, seed=4))
    tp = gt.Parameters(mean=gt.zero(), kernel=_kernel(gt, name))
    z = 10.0 * torch.eye(100, dtype=torch.float64)
    got = gp._logml_value_and_grad_hybrid(tp, x, y, gp.LOGML_NUGGET, z=z,
                                          deflate=16, base=64)
    want = gp.logml_value_and_grad(tp, x, y)
    np.testing.assert_allclose(_flat(got[0], got[1].kernel),
                               _flat(want[0], want[1].kernel), rtol=1e-8)


def test_params_from_numpy_carries_families():
    """gpx's flattened leaves carried into a port template with Matérn's nu
    (static in both packages: the template's), a Product and an Ard over
    one: the same names and values in gpx's flatten order."""
    jk = (gpx.se(1.0, 2.0) * gpx.matern(0.5, 2.5, 3.0)
          + gpx.ard(gpx.matern(0.7, 0.5, 1.0) * gpx.periodic(1.1, 2.0, 0.9),
                    [0.5, 4.0]) + gpx.white(0.2))
    jp = gpx.Parameters(mean=gpx.zero(), kernel=jk)
    template = gt.Parameters(mean=gt.zero(), kernel=(
        gt.se(0.0, 0.0, **F64) * gt.matern(0.0, 2.5, 0.0, **F64)
        + gt.ard(gt.matern(0.0, 0.5, 0.0, **F64)
                 * gt.periodic(0.0, 0.0, 0.0, **F64), [0.0, 0.0], **F64)
        + gt.white(0.0, **F64)))
    tp = params_from_numpy(template, jax.tree_util.tree_leaves(jp))
    assert tparams.names(tp) == gpx.params.names(jp)
    np.testing.assert_array_equal(tparams.to_array(tp).numpy(),
                                  np.asarray(gpx.params.to_array(jp)))
    assert [k.nu for k in (tp.kernel.kernels[0].kernels[1],
                           tp.kernel.kernels[1].base.kernels[0])] == [2.5, 0.5]


def test_card_gates_by_structure():
    """What the CUDA term table takes (a Product of Sums that expands past
    its 8 factors stays on the torch route), the gates on a float32 card
    tensor (a stand-in: they read only its device, type and shape), and the
    128-output limit."""
    f32 = dict(device="cpu", dtype=torch.float32)
    se, wh = gt.se(1.0, 2.0, **f32), gt.white(0.5, **f32)
    per = gt.periodic(1.0, 3.0, 2.0, **f32)
    past = gt.Product(((se + wh), (per + se), (se + wh)))  # 8 x 3 factors
    assert (se * per + wh).cuda_supported and (se * per).cuda_supported
    assert gt.Product(((se + wh), per)).cuda_supported
    assert not past.cuda_supported
    assert not gt.matern(1.0, 1.3, 2.0, **f32).cuda_supported
    assert not gt.Sum((se,) * 9).cuda_supported  # more than 8 terms
    on_card = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32,
                              shape=(gp.FUSED_MIN_N, 3))
    ard = gt.ard(gt.matern(2.0, 2.5, 1.0, **f32) + wh, ELL, **f32)
    assert gp._fused_gate(ard, on_card)
    assert gp._fused_gate(gt.Product(((se + wh), per)), on_card)
    assert not gp._fused_gate(past, on_card)
    gp._hybrid_gate(ard)
    x = torch.zeros((64, 127), dtype=torch.float64)
    with pytest.raises(ValueError, match="128"):
        cuda_logml_grad.logml_kernel_grads(
            gt.se(1.0, 1.0, **F64), x, torch.zeros(64, dtype=torch.float64),
            torch.eye(64, dtype=torch.float64), ard=True)
