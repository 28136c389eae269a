"""The port's main path against the JAX package, in float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.models import gp as jgp
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy, params_to_numpy
from gpx_torch.models import gp

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)


def _gpx_value_and_grad(jp, x, y, method="analytic"):
    # one jitted program compiles in a fraction of eager op-by-op dispatch
    fn = jax.jit(lambda p, x_, y_: jgp.logml_value_and_grad(p, x_, y_,
                                                            method=method))
    return fn(jp, jnp.asarray(x), jnp.asarray(y))


def _pair(mean: str = "zero"):
    """The same parameters in both packages."""
    if mean == "plane":
        jm, tm = gpx.plane([0.3, -0.2]), gt.plane([0.0, 0.0], **F64)
    else:
        jm, tm = gpx.zero(), gt.zero()
    jp = gpx.Parameters(mean=jm, kernel=gpx.se(3.0, 5.5) + gpx.white(0.5))
    template = gt.Parameters(mean=tm, kernel=gt.se(1.0, 1.0, **F64)
                             + gt.white(1.0, **F64))
    tp = params_from_numpy(template, jax.tree_util.tree_leaves(jp))
    return jp, tp


def _data(rng, n):
    x = rng.uniform(-10, 10, size=(n, 1))
    y = rng.normal(size=n)
    return x, y


def _assert_close(got, want, rtol):
    value, grads = got
    jv, jg = want
    np.testing.assert_allclose(float(value), float(jv), rtol=rtol)
    np.testing.assert_allclose(
        np.concatenate([np.ravel(a) for a in params_to_numpy(grads)]),
        np.concatenate([np.ravel(np.asarray(a))
                        for a in jax.tree_util.tree_leaves(jg)]),
        rtol=rtol)


@pytest.mark.parametrize("mean", ["zero", "plane"])
def test_analytic_matches_gpx(rng, mean):
    """The non-fused analytic route (CPU) against gpx's, n = 200."""
    jp, tp = _pair(mean)
    x, y = _data(rng, 200)
    want = _gpx_value_and_grad(jp, x, y)
    got = gp.logml_value_and_grad(tp, torch.as_tensor(x), torch.as_tensor(y))
    _assert_close(got, want, rtol=1e-10)


def test_autodiff_matches_gpx(rng):
    jp, tp = _pair()
    x, y = _data(rng, 200)
    want = _gpx_value_and_grad(jp, x, y, method="autodiff")
    got = gp.logml_value_and_grad(tp, torch.as_tensor(x), torch.as_tensor(y),
                                  method="autodiff")
    _assert_close(got, want, rtol=1e-10)


def test_fused_core_padded_matches_gpx_autodiff(rng):
    """The fused core at n = 290 (padded to 384: an uneven 256 + 128 Schur
    split) through the plain versions of its kernels, against gpx's
    autodiff oracle. The first-order logdet correction is exact to second
    order in the factor's error, so in float64 the two meet to round-off."""
    jp, tp = _pair()
    x, y = _data(rng, 290)
    v_a, want = _gpx_value_and_grad(jp, x, y, method="autodiff")
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    k = gp.gram(tp.kernel, xt, nugget=gp.LOGML_NUGGET)
    value, d_kernel, alpha = gp._fused_logml_core(tp.kernel, xt, yt, k,
                                                  gp.LOGML_NUGGET)
    assert alpha.shape == (290,)
    np.testing.assert_allclose(float(value), float(v_a), rtol=1e-8)
    np.testing.assert_allclose(
        [float(t) for t in tparams.leaves(d_kernel)],
        [float(t) for t in jax.tree_util.tree_leaves(want.kernel)], rtol=1e-8)


def test_leaf_order_matches_gpx_names():
    jp = gpx.Parameters(
        mean=gpx.plane([0.1, 0.2, 0.3]),
        kernel=gpx.se(1.0, 2.0) + gpx.matern(0.5, 2.5, 3.0) * gpx.white(0.1)
        + gpx.ard(gpx.rational_quadratic(1.0, 2.0, 1.0), [0.5, 4.0]))
    template = gt.Parameters(
        mean=gt.plane([0.0, 0.0, 0.0], **F64),
        kernel=gt.se(0.0, 0.0, **F64)
        + gt.matern(0.0, 2.5, 0.0, **F64) * gt.white(0.0, **F64)
        + gt.ard(gt.rational_quadratic(0.0, 0.0, 0.0, **F64), [0.0, 0.0],
                 **F64))
    tp = params_from_numpy(template, jax.tree_util.tree_leaves(jp))
    assert tparams.names(tp) == gpx.params.names(jp)
    np.testing.assert_array_equal(tparams.to_array(tp).numpy(),
                                  np.asarray(gpx.params.to_array(jp)))
    assert tparams.names(tparams.from_array(tp, tparams.to_array(tp))) == \
        tparams.names(tp)


def test_numpy_round_trip():
    jp, tp = _pair("plane")
    arrays = params_to_numpy(tp)
    for a, b in zip(arrays, jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = params_from_numpy(tp, arrays)
    for a, b in zip(tparams.leaves(back), tparams.leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_unported_options_raise():
    """An unknown method stays an error. ``fast_gradients`` and
    ``method="hybrid"`` are ported (tests/test_torch_fast.py,
    tests/test_torch_hybrid.py): off the fused route the flag is ignored,
    as in gpx, so it no longer raises."""
    _, tp = _pair()
    x = torch.linspace(-1.0, 1.0, 4, dtype=torch.float64)[:, None]
    y = torch.zeros(4, dtype=torch.float64)
    value, _ = gp.logml_value_and_grad(tp, x, y, fast_gradients=True)
    assert torch.equal(value, gp.logml_value_and_grad(tp, x, y)[0])
    with pytest.raises(ValueError):
        gp.logml_value_and_grad(tp, x, y, method="exact")
