"""The 2-pass legs on the CPU: ``fast_gradients=True`` against the JAX
package and against the port's own ``False``; the plain versions of the
fast ``trmm`` and ``logml_kernel_grads`` against float64 and against
gpx's interpret-mode ``fast=True`` kernels; ``chol_inv(fast=True)``'s
structure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.models import gp as jgp
from gpx.ops.pallas_logml_grad import logml_kernel_grads as jax_logml_kernel_grads
from gpx.ops.pallas_trmm import trmm as jax_trmm
from gpx_torch.convert import params_from_numpy, params_to_numpy
from gpx_torch.models import gp
from gpx_torch.ops import cuda_chol, cuda_logml_grad, cuda_trmm
from gpx_torch.ops.distance import sq_distances
from gpx_torch.ops.terms import term_derivatives
from gpx_torch.params import leaves

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
# TF32 rounds to nearest with 10 mantissa bits: 2^-11 relative per
# rounded operand; gpx's bf16 keeps 7 bits, 2^-9
PORT_REL = 2.0 ** -10
GPX_REL = 2.0 ** -8


def _pair(name):
    if name == "se+white":
        jk = gpx.se(3.0, 5.5) + gpx.white(0.5)
        tk = gt.se(1.0, 1.0, **F64) + gt.white(1.0, **F64)
    else:
        jk = gpx.ard(gpx.matern(2.0, 2.5, 1.0) + gpx.white(0.25),
                     [0.7, 2.3, 1.4])
        tk = gt.ard(gt.matern(1.0, 2.5, 1.0, **F64) + gt.white(1.0, **F64),
                    [1.0, 1.0, 1.0], **F64)
    jp = gpx.Parameters(mean=gpx.zero(), kernel=jk)
    tp = params_from_numpy(gt.Parameters(mean=gt.zero(), kernel=tk),
                           jax.tree_util.tree_leaves(jp))
    return jp, tp


@pytest.mark.parametrize("name", ["se+white", "ard"])
def test_fast_gradients_is_the_analytic_result_off_the_fused_route(rng, name):
    """gpx ignores fast_gradients=True off its fused route, and so does the
    port: both agree to round-off in float64, and the port's result is
    bitwise its own fast_gradients=False one (autodiff and hybrid too)."""
    jp, tp = _pair(name)
    d = 1 if name == "se+white" else 3
    x = rng.uniform(-10, 10, size=(40, d))
    y = rng.normal(size=40)
    jv, jg = jax.jit(lambda p, x_, y_: jgp.logml_value_and_grad(
        p, x_, y_, fast_gradients=True))(jp, jnp.asarray(x), jnp.asarray(y))
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    value, grads = gp.logml_value_and_grad(tp, xt, yt, fast_gradients=True)
    np.testing.assert_allclose(float(value), float(jv), rtol=1e-10)
    np.testing.assert_allclose(
        np.concatenate([np.ravel(a) for a in params_to_numpy(grads)]),
        np.concatenate([np.ravel(np.asarray(a))
                        for a in jax.tree_util.tree_leaves(jg)]),
        rtol=1e-8)
    v0, g0 = gp.logml_value_and_grad(tp, xt, yt)
    assert torch.equal(value, v0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(grads), leaves(g0)))
    for method in ("autodiff", "hybrid"):
        v1, g1 = gp.logml_value_and_grad(tp, xt, yt, method=method)
        v2, g2 = gp.logml_value_and_grad(tp, xt, yt, method=method,
                                         fast_gradients=True)
        assert torch.equal(v1, v2)
        assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))


def test_round_tf32():
    """Round to nearest on the float32 bits, ties away from zero, 10
    mantissa bits kept."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -11, 0.0, -0.0, float("inf")], **F64)
    want = [1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -9,
            0.0, -0.0, float("inf")]
    assert cuda_trmm.round_tf32(x).tolist() == want
    y = torch.randn(1000, dtype=torch.float32)
    r = cuda_trmm.round_tf32(y)
    assert r.dtype == torch.float32
    assert bool(((r - y).abs() <= 2.0 ** -11 * y.abs()).all())
    assert bool((r.view(torch.int32) & 0x1FFF == 0).all())


@pytest.mark.parametrize("mode,neg", [("right_lower", True),
                                      ("left_lower", False)])
def test_fast_trmm_reference(rng, mode, neg):
    """The plain fast trmm against the exact float64 product within 2^-10
    of each entry's sum of |terms|, and against gpx's interpret-mode
    trmm(fast=True) within gpx's own 2^-8."""
    n = 128
    l = np.tril(rng.normal(size=(n, n))) / np.sqrt(n) + 2.0 * np.eye(n)
    b = rng.normal(size=(n, n))
    lt, bt = torch.as_tensor(l), torch.as_tensor(b)
    got = cuda_trmm.trmm(bt, lt, mode=mode, neg=neg, fast=True)
    exact = cuda_trmm.trmm_reference(bt, lt, mode=mode, neg=neg)
    scale = cuda_trmm.trmm_reference(bt.abs(), lt.abs(), mode=mode)
    assert bool(((got - exact).abs() <= PORT_REL * scale).all())
    assert not torch.equal(got, exact)
    want = np.array(jax_trmm(jnp.asarray(b), jnp.asarray(l), mode=mode,
                               bt=64, interpret=True, neg=neg, fast=True))
    assert bool(((got - torch.as_tensor(want)).abs() <= GPX_REL * scale).all())
    with pytest.raises(ValueError):
        cuda_trmm.trmm(bt, lt, mode="right_lower_t", fast=True)


def _grad_scales(kernel, x, alpha, l_inv):
    """Per output, what one rounded operand can move it by at most, over
    2^-11: 0.5 sum |L^-1|^T |L^-1| |dK/dtheta| per hyperparameter, the
    same with |K| for tr(W_hat K) and the diagonal sum for tr(W_hat)."""
    m = l_inv.abs().T @ l_inv.abs()
    r2 = sq_distances(x)
    out = [float(0.5 * torch.sum(m * dk.abs()))
           for dk in term_derivatives(kernel, r2)]
    return out + [float(torch.sum(m * kernel.evaluate_r2(r2).abs())),
                  float(torch.trace(m))]


def test_fast_logml_grads_reference(rng):
    """The plain fast gradient contraction against the exact float64 one
    within 2^-10 of each output's scale (_grad_scales), and against gpx's
    interpret-mode logml_kernel_grads(fast=True) within 2^-8."""
    n = 128
    x = rng.uniform(-10, 10, size=(n, 1))
    y = 3.0 * rng.normal(size=n)
    k = np.asarray((gpx.se(1.0, 2.0) + gpx.white(0.5)).gram(
        jnp.asarray(x), nugget=1e-3, method="xla"))
    l_inv = np.linalg.inv(np.linalg.cholesky(k))
    alpha = l_inv.T @ (l_inv @ y)
    kern = gt.se(1.0, 2.0, **F64) + gt.white(0.5, **F64)
    args = (kern, torch.as_tensor(x), torch.as_tensor(alpha),
            torch.as_tensor(l_inv))

    def flat(out):
        d_k, (tkw, trw) = out
        return np.array([float(t) for t in leaves(d_k)] + [float(tkw),
                                                          float(trw)])

    got = flat(cuda_logml_grad.logml_kernel_grads(*args, fast=True))
    exact = flat(cuda_logml_grad.logml_kernel_grads_reference(*args))
    scales = np.array(_grad_scales(kern, args[1], args[2], args[3]))
    assert np.all(np.abs(got - exact) <= PORT_REL * scales)
    assert np.any(got != exact)
    jk, (jt, jr) = jax_logml_kernel_grads(
        gpx.se(1.0, 2.0) + gpx.white(0.5), jnp.asarray(x), jnp.asarray(alpha),
        jnp.asarray(l_inv), bt=64, interpret=True, with_correction=True,
        fast=True)
    want = np.array([float(v) for v in jax.tree_util.tree_leaves(jk)]
                    + [float(jt), float(jr)])
    assert np.all(np.abs(got - want) <= GPX_REL * scales)


@pytest.mark.parametrize("n", [256, 320])
def test_chol_inv_fast_structure(rng, n):
    """chol_inv(fast=True) through the plain versions: L bitwise fast=False's,
    M bitwise outside the outermost M21, which differs by no more than the
    two rounded products can move it."""
    a = rng.normal(size=(n, n))
    spd = torch.as_tensor(a @ a.T / n + np.eye(n))
    l0, m0 = cuda_chol.chol_inv(spd, base=64)
    l1, m1 = cuda_chol.chol_inv(spd, base=64, fast=True)
    h = cuda_chol._split(n)
    assert torch.equal(l0, l1)
    rest = torch.ones((n, n), dtype=torch.bool)
    rest[h:, :h] = False
    assert torch.equal(m0[rest], m1[rest])
    m21 = m1[h:, :h]
    assert not torch.equal(m21, m0[h:, :h])
    # M21 = -M22 (L21 M11), each product with its right operand rounded
    bound = 2.0 ** -11 * (m0[h:, h:].abs() @ (l0[h:, :h].abs() @ m0[:h, :h].abs())) * 2.01
    assert bool(((m21 - m0[h:, :h]).abs() <= bound).all())
    with pytest.raises(ValueError):
        cuda_chol.chol_inv(spd, base=64, spine=True, fast=True)
