"""Softmax-Laplace classification of the port (``classify``) against the
JAX package, in float64 on the CPU: C = 3 classes of Gaussian blobs in D =
2 (``examples/mnist_classify.py``'s synthetic digits), N = 36 training and
M = 8 test points. ``fit`` with a shared kernel and with a per-class list
(the mode, the probabilities, the approximate log marginal, E, chol(sum
E) within 1e-10 of each array's largest entry; the Newton iteration count
equal), ``latent_predict``'s moments, and ``predict`` on gpx's own normals
(fed to the port's ``torch.randn``). gpx's oracles are one jitted program,
compiled for compile time."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.models import classify as jcl
from gpx_torch.models import classify

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
C, N_PER, M, N_MC = 3, 12, 8, 50
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}
KEY = jax.random.PRNGKey(4)


def _data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(C, 2)) * 2.0
    x = np.concatenate([centers[c] + rng.normal(size=(N_PER + 3, 2)) * 0.8
                        for c in range(C)])
    y = np.repeat(np.arange(C), N_PER + 3)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    return x[:-M], y[:-M], x[-M:]


def _kernels(se, white, **kw):
    shared = se(1.0, 2.0, **kw) + white(0.1, **kw)
    per_class = [se(h, s, **kw) + white(0.1, **kw)
                 for h, s in ((1.0, 1.5), (1.2, 2.0), (0.8, 2.5))]
    return {"shared": shared, "per_class": per_class}


def _oracles():
    x, y, xs = (jnp.asarray(a) for a in _data())
    o = {}
    for case, kern in _kernels(gpx.se, gpx.white).items():
        r = jcl.fit(x, kern, y, C)
        o[case] = (r.f, r.pi, r.log_marginal, r.e, r.m_chol, r.n_iters,
                   jcl.latent_predict(r, x, kern, xs))
        if case == "per_class":
            o["predict"] = jcl.predict(KEY, r, x, kern, xs, n_mc=N_MC)
    o["normals"] = jax.vmap(lambda k: jax.random.normal(
        k, (N_MC, C), dtype=jnp.float64))(jax.random.split(KEY, M))
    f, yh = _helper_inputs()
    oh = jcl.encode_labels(jnp.asarray(yh), C)
    o["helpers"] = (oh, jcl.softmax_probs(jnp.asarray(f)),
                    jcl.softmax_log_likelihood(jnp.asarray(f), oh))
    return o


def _helper_inputs():
    return (np.random.default_rng(1).normal(size=(C, 6)),
            np.array([0, 2, 1, 1, 0, 2]))


@pytest.fixture(scope="module")
def ref():
    fn = jax.jit(_oracles, compiler_options=_FAST_COMPILE)
    o = jax.tree_util.tree_map(np.asarray, fn())
    x, y, xs = _data()
    ports = {}
    for case, kern in _kernels(gt.se, gt.white, **F64).items():
        ports[case] = (kern, classify.fit(_t(x), kern, _t(y), C))
    return (x, y, xs), o, ports


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-10):
    """Within ``rtol`` of the array's largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("case", ["shared", "per_class"])
def test_fit_against_gpx(ref, case):
    """The mode, pi, log Z, E, chol(sum E) and the Newton count."""
    _, o, ports = ref
    got = ports[case][1]
    want = o[case]
    for g, w in zip((got.f, got.pi, got.log_marginal, got.e, got.m_chol),
                    want[:5]):
        _close(g, w)
    assert int(got.n_iters) == int(want[5]) > 1
    assert got.k.shape == (C, len(ref[0][0]), len(ref[0][0]))


@pytest.mark.parametrize("case", ["shared", "per_class"])
def test_latent_predict_against_gpx(ref, case):
    """mu (C, M) and the cross-class covariance sigma (M, C, C), solved per
    class; sigma's diagonal positive."""
    (x, _, xs), o, ports = ref
    kern, fitres = ports[case]
    mu, sigma = classify.latent_predict(fitres, _t(x), kern, _t(xs))
    _close(mu, o[case][6][0])
    _close(sigma, o[case][6][1])
    assert (torch.diagonal(sigma, dim1=1, dim2=2) > 0).all()


def test_predict_on_gpx_normals(ref, monkeypatch):
    """gpx's Monte-Carlo class probabilities on its own normals (one (n_mc,
    C) block per test point), which the port's generator is made to
    return; rows sum to 1."""
    (x, _, xs), o, ports = ref
    kern, fitres = ports["per_class"]
    z = _t(o["normals"])
    monkeypatch.setattr(torch, "randn", lambda *a, **k: z)
    got = classify.predict(torch.Generator(), fitres, _t(x), kern, _t(xs),
                           n_mc=N_MC)
    assert got.shape == (M, C)
    _close(got, o["predict"])
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-12)


def test_likelihood_helpers(ref):
    """softmax_probs, encode_labels and softmax_log_likelihood."""
    f, y = _helper_inputs()
    want = ref[1]["helpers"]
    oh = classify.encode_labels(_t(y), C)
    np.testing.assert_array_equal(oh.numpy(), want[0])
    _close(classify.softmax_probs(_t(f)), want[1])
    _close(classify.softmax_log_likelihood(_t(f), oh.double()), want[2])


def test_module_has_every_public_name():
    """Every function and class gpx's classify defines exists in the
    port's."""
    want = [k for k, v in vars(jcl).items() if not k.startswith("__")
            and getattr(v, "__module__", None) == jcl.__name__]
    tmod = importlib.import_module("gpx_torch.models.classify")
    assert want and not [k for k in want if not hasattr(tmod, k)]
