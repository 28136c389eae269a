"""The structured models of the port (``multioutput``,
``multioutput_iterative``, ``gridgp``) against the JAX package, in float64
on the CPU: an ICM and an LMC with N = 24, T = 3, a 16 x 8 grid (the second
axis 2-D) and a coregionalized 3 x 16 grid. Values and autograd's gradient
in every parameter leaf within 1e-10 of each array's largest entry unless a
test says otherwise; ``kron_matvec`` at T R = 15 and 18 columns (not
multiples of the card kernel's 16-column chunks); the iterative estimators
on gpx's own probe draws; draws on the same standard normals (gpx's, fed to
the port). gpx's oracles are one jitted program of the parameter trees,
compiled for compile time once and run again at the port's optimizer and
sampler results. The Kronecker paths' gradients hold the eigenbases
constant: a rank-2 W with T = 4 repeats B's eigenvalue kappa = 0.3,
where the kron gradient meets gpx's dense one, and the float32 kron and
grid gradients are finite and near gpx's float64 ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.models import gridgp as jgrid
from gpx.models import multioutput as jmo
from gpx.models import multioutput_iterative as jmi
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy
from gpx_torch.kernels import Kernel
from gpx_torch.models import gridgp, multioutput, multioutput_iterative
from tests.torch_parallel_ranks import one_rank_mesh

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
N, T, S, RANK = 24, 3, 4, 8
KEY = jax.random.PRNGKey(3)
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


def _data():
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(-5.0, 5.0, (N, 1)), axis=0)
    phase = rng.uniform(0.0, 2.0, T)
    Y = np.sin(x + phase[None, :]) + 0.2 * rng.normal(size=(N, T))
    mask = rng.uniform(size=(N, T)) > 0.25
    a1 = np.sort(rng.uniform(-5.0, 5.0, (16, 1)), axis=0)
    a2 = rng.uniform(-2.0, 2.0, (8, 2))
    return dict(
        x=x, Y=Y, mask=mask, Ym=np.where(mask, Y, np.nan),
        xs=np.linspace(-6.0, 6.0, 7)[:, None],
        w=rng.normal(size=(T, 2)) * 0.6, kappa=np.array([0.3, 0.4, 0.5]),
        v15=rng.normal(size=(N * T, 5)), v18=rng.normal(size=(N * T, 6)),
        a1=a1, a2=a2, Yg=np.sin(a1) + 0.3 * rng.normal(size=(16, 8)),
        gmask=rng.uniform(size=(16, 8)) > 0.2,
        xg=np.concatenate([rng.uniform(-5, 5, (10, 1)),
                           rng.uniform(-2, 2, (10, 2))], axis=1),
        vg=rng.normal(size=(16, 8, 3)), wg=rng.normal(size=(T, 2)) * 0.6,
        Yc=np.sin(a1.T) + 0.3 * rng.normal(size=(T, 16)),
        xc=np.stack([np.repeat(np.arange(T), 3),
                     np.tile(np.linspace(-4.0, 4.0, 3), T)], axis=1),
        **_data4(x))


def _data4(x):
    """T = 4 outputs and a rank-2 W over the same x: B = W W^T + 0.3 I has
    the eigenvalue 0.3 twice."""
    rng = np.random.default_rng(7)
    phase = rng.uniform(0.0, 2.0, 4)
    return dict(w4=rng.normal(size=(4, 2)) * 0.6,
                Y4=3.0 * np.sin(0.7 * x + phase[None, :])
                + 0.5 * rng.normal(size=(N, 4)))


def _gpx_trees(d):
    """gpx's parameter trees, with strong float64 leaves (so a second call
    of the oracle program reuses its compile)."""
    trees = dict(
        icm=jmo.icm(gpx.matern(1.3, 0.5, 1.6) + gpx.white(0.05), T, 2, w=d["w"],
                    kappa=d["kappa"], noise=0.1),
        pn=jmo.icm(gpx.se(1.3, 1.6), T, 2, w=d["w"], kappa=d["kappa"],
                   noise=np.array([0.1, 0.2, 0.15])),
        lmc=jmo.lmc([gpx.se(1.3, 1.6), gpx.matern(0.7, 1.5, 2.0)], T,
                    kappa=0.3, noise=0.1),
        grid=jgrid.grid([gpx.se(1.2, 0.7), gpx.matern(1.0, 1.5, 1.0)],
                        noise=0.2),
        cgrid=jgrid.grid([jgrid.coregion_axis(T, 2, w=d["wg"]),
                          gpx.se(1.0, 0.7)], noise=0.1),
        rep=jmo.icm(gpx.se(2.0, 2.0), 4, 2, w=d["w4"], kappa=0.3, noise=0.5))
    return jax.tree_util.tree_map(lambda a: jnp.array(a, jnp.float64), trees)


def _port_trees(d, trees):
    c = F64
    templates = dict(
        icm=multioutput.icm(gt.matern(1.0, 0.5, 1.0, **c) + gt.white(1.0, **c),
                            T, 2),
        pn=multioutput.icm(gt.se(1.0, 1.0, **c), T, 2, noise=np.ones(T)),
        lmc=multioutput.lmc([gt.se(1.0, 1.0, **c),
                             gt.matern(1.0, 1.5, 1.0, **c)], T),
        grid=gridgp.grid([gt.se(1.0, 1.0, **c), gt.matern(1.0, 1.5, 1.0, **c)]),
        cgrid=gridgp.grid([gridgp.coregion_axis(T, 2, **c),
                           gt.se(1.0, 1.0, **c)]),
        rep=multioutput.icm(gt.se(1.0, 1.0, **c), 4, 2))
    return {k: params_from_numpy(t, jax.tree_util.tree_leaves(trees[k]))
            for k, t in templates.items()}


def _per_key_rademacher(key, n, s):
    return jax.vmap(lambda k: jax.random.rademacher(k, (n,), dtype=jnp.float64),
                    out_axes=1)(jax.random.split(key, s))


def _oracles(tr, d, mask, gmask):
    x, Y, xs = d["x"], d["Y"], d["xs"]
    icm, pn, lmc = tr["icm"], tr["pn"], tr["lmc"]
    o = {}
    vg = jax.value_and_grad

    def lml(y=Y, **kw):
        return lambda p: jmo.log_marginal_likelihood(p, x, y, **kw)

    o["kron"] = vg(lml(method="kron"))(icm)
    o["masked"] = vg(lml(d["Ym"], mask=mask))(icm)
    o["pn"] = vg(lml())(pn)
    o["rep"] = vg(lml(d["Y4"], method="dense"))(tr["rep"])
    o["lmc"] = vg(lml())(lmc)
    o["gram_full"] = jmo.gram_full(lmc, x, nugget=1e-3)
    f = jmo.fit(icm, x, Y, xs)
    o["fit_kron"] = (f.mean, f.variance, f.interval(0.9))
    f = jmo.fit(lmc, x, d["Ym"], xs, mask=mask)
    o["fit_lmc"] = (f.mean, f.variance)
    k_pd = jax.random.PRNGKey(9)
    o["pdraw"] = (jmo.posterior_draw(k_pd, pn, x, d["Ym"], xs, shape=(2,),
                                     mask=mask),
                  jax.random.normal(k_pd, (2, T * xs.shape[0])))
    # the pieces of a draw: chol(K_q + nugget I) and B_q per term
    o["draw"] = [(jnp.linalg.cholesky(k.gram(x, nugget=1e-3)), b)
                 for k, b in jmo._terms(lmc)]

    mv = jmi.kron_matvec(icm, x, nugget=1e-3)
    o["mv"] = (mv(d["v15"]), mv(d["v18"]), mv(d["v15"][:, 0]),
               jmi.kron_matvec(lmc, x, nugget=1e-3)(d["v18"]))
    pc = jmi.kron_preconditioner(icm, x, RANK, nugget=1e-3)
    k_u = jax.random.PRNGKey(4)
    o["precond"] = (pc.apply(d["v15"]), pc.logdet,
                    pc.sample(k_u, S, base="rademacher"),
                    jax.random.rademacher(k_u, (N, T, S), dtype=jnp.float64))
    k_slq, k_probe = jax.random.split(KEY)
    o["noise"] = (jax.random.rademacher(k_probe, (N * T, S),
                                        dtype=jnp.float64),
                  _per_key_rademacher(k_slq, N * T, S))
    o["iter"] = jmi.logml_value_and_grad_iterative(
        icm, x, Y, KEY, n_probes=S, lanczos_iters=10, cg_tol=1e-10)
    o["fit_iter"] = jmi.fit_iterative(icm, x, Y, xs, cg_tol=1e-10,
                                      precond_rank=RANK, variance_block=4)

    g, axes = tr["grid"], [d["a1"], d["a2"]]
    o["grid"] = vg(lambda p: jgrid.log_marginal_likelihood(p, axes, d["Yg"]))(g)
    caxes = [jgrid.output_axis(T), d["a1"]]
    o["cgrid"] = vg(lambda p: jgrid.log_marginal_likelihood(p, caxes, d["Yc"])
                    )(tr["cgrid"])
    f = jgrid.fit(tr["cgrid"], caxes, d["Yc"], d["xc"])
    o["cfit"] = (f.mean, f.variance)
    f = jgrid.fit(g, axes, d["Yg"], d["xg"])
    o["gfit"] = (f.mean, f.variance)
    o["gfit_mask"] = jgrid.fit(g, axes, d["Yg"], d["xg"], mask=gmask,
                               cg_tol=1e-10).mean
    gmv = jgrid.kron_matvec(g, axes, nugget=1e-3)
    o["gmv"] = (gmv(d["vg"][..., 0]),
                jax.vmap(gmv, in_axes=2, out_axes=2)(d["vg"]))
    o["grams"] = [k.gram(a) for k, a in zip(g.kernels, axes)]
    o["coords"] = jgrid.grid_coords(axes)
    o["gpdraw"] = (jgrid.posterior_draw(k_pd, g, axes, d["Yg"], d["xg"],
                                        shape=(2,)),
                   jax.random.normal(k_pd, (2, d["xg"].shape[0])))
    return o


@pytest.fixture(scope="module")
def ref():
    d = _data()
    jd = {k: jnp.asarray(v) for k, v in d.items() if k not in ("mask", "gmask")}
    trees = _gpx_trees(d)
    fn = jax.jit(lambda tr: _oracles(tr, jd, d["mask"], d["gmask"]),
                 compiler_options=_FAST_COMPILE)
    o = jax.tree_util.tree_map(np.asarray, fn(trees))
    return d, o, trees, fn, _port_trees(d, trees)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-10):
    """Within ``rtol`` of the array's largest entry."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _value_grad(fn, p):
    ls = [t.clone().requires_grad_() for t in tparams.leaves(p)]
    value = fn(tparams.unflatten(p, ls))
    return value, torch.autograd.grad(value, ls)


def _hold_vg(fn, p, want, rtol=1e-10):
    value, grads = _value_grad(fn, p)
    _close(value, want[0], rtol)
    want_g = jax.tree_util.tree_leaves(want[1])
    assert len(grads) == len(want_g)
    for g, w in zip(grads, want_g):
        _close(g, w, rtol)


# -- multioutput ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["kron", "dense", "masked", "pn", "lmc"])
def test_logml_and_gradient(ref, case):
    """An ICM over Matern 1/2 + White (a spectrum without near-repeated
    eigenvalues, where the eigh VJP is accurate) on the kron path, and on
    the dense path against gpx's kron numbers (the same function: within
    1e-9); a mask with NaN placeholders; per-output noise (dense by
    "auto"); an LMC of SE and Matern 3/2 (every leaf)."""
    d, o, _, _, tp = ref
    x = _t(d["x"])
    kw = {"kron": dict(method="kron"), "dense": dict(method="dense"),
          "masked": dict(mask=d["mask"]), "pn": {}, "lmc": {}}[case]
    Y = _t(d["Ym"] if case == "masked" else d["Y"])
    p = tp[{"pn": "pn", "lmc": "lmc"}.get(case, "icm")]
    _hold_vg(lambda q: multioutput.log_marginal_likelihood(q, x, Y, **kw), p,
             o["kron" if case == "dense" else case],
             1e-9 if case == "dense" else 1e-10)


def _f32(tree):
    return tparams.unflatten(tree, [t.float() for t in tparams.leaves(tree)])


def test_kron_gradient_at_repeated_eigenvalue(ref):
    """B = W W^T + 0.3 I with a rank-2 W and T = 4 (0.3 twice): the kron
    value and gradient against gpx's dense ones, within 1e-8 of the
    gradient's norm (through eigh's VJP it missed by 1.4e-3 of the norm
    here, and by 6.3e-2 in float32)."""
    d, o, _, _, tp = ref
    value, grads = _value_grad(lambda q: multioutput.log_marginal_likelihood(
        q, _t(d["x"]), _t(d["Y4"]), method="kron"), tp["rep"])
    want_v, want_g = o["rep"][0], jax.tree_util.tree_leaves(o["rep"][1])
    np.testing.assert_allclose(float(value.detach()), float(want_v), rtol=1e-12)
    norm = np.sqrt(sum(float(np.sum(np.square(w))) for w in want_g))
    assert len(grads) == len(want_g)
    for g, w in zip(grads, want_g):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-8 * norm


@pytest.mark.parametrize("case", ["kron", "grid"])
def test_float32_gradient_finite(ref, case):
    """The kron ICM at B's repeated eigenvalue and the 16 x 8 grid in
    float32: value within 1e-5 relative and every leaf's gradient within
    1e-4 of the gradient's norm of gpx's float64 ones (float32 rounding of
    the eigendecompositions: ~2e-6 here). On the card, float32 eigh VJPs
    were NaN in h and sigma; the CPU's LAPACK gives no NaN at this size."""
    d, o, _, _, tp = ref
    f32 = dict(dtype=torch.float32)
    if case == "kron":
        fn = lambda q: multioutput.log_marginal_likelihood(  # noqa: E731
            q, _t(d["x"]).to(**f32), _t(d["Y4"]).to(**f32), method="kron")
        p, want = tp["rep"], o["rep"]
    else:
        axes = [_t(d["a1"]).to(**f32), _t(d["a2"]).to(**f32)]
        fn = lambda q: gridgp.log_marginal_likelihood(  # noqa: E731
            q, axes, _t(d["Yg"]).to(**f32))
        p, want = tp["grid"], o["grid"]
    value, grads = _value_grad(fn, _f32(p))
    want_g = jax.tree_util.tree_leaves(want[1])
    np.testing.assert_allclose(float(value.detach()), float(want[0]), rtol=1e-5)
    norm = np.sqrt(sum(float(np.sum(np.square(w))) for w in want_g))
    for g, w in zip(grads, want_g):
        assert torch.isfinite(g).all()
        assert np.abs(g.double().numpy() - np.asarray(w)).max() <= 1e-4 * norm


def test_fit_gram_full_and_checks(ref):
    d, o, _, _, tp = ref
    x, Y, xs = _t(d["x"]), _t(d["Y"]), _t(d["xs"])
    f = multioutput.fit(tp["icm"], x, Y, xs)
    for got, want in zip((f.mean, f.variance, f.interval(0.9)), o["fit_kron"]):
        _close(got, want)
    f = multioutput.fit(tp["icm"], x, Y, xs, method="dense")
    for got, want in zip((f.mean, f.variance), o["fit_kron"]):
        _close(got, want, 1e-9)
    f = multioutput.fit(tp["lmc"], x, _t(d["Ym"]), xs,
                        mask=torch.as_tensor(d["mask"]))
    for got, want in zip((f.mean, f.variance), o["fit_lmc"]):
        _close(got, want)
    _close(multioutput.gram_full(tp["lmc"], x, nugget=1e-3), o["gram_full"])
    with pytest.raises(ValueError):
        multioutput.log_marginal_likelihood(tp["lmc"], x, Y, method="kron")
    with pytest.raises(ValueError):
        multioutput.log_marginal_likelihood(tp["pn"], x, Y, method="kron")
    with pytest.raises(ValueError):
        multioutput.log_marginal_likelihood(tp["icm"], x, Y[:, :2])
    with pytest.raises(ValueError):
        multioutput._obs_index(d["mask"].astype(int), N, T)
    want = jax.tree_util.tree_leaves(jmo.icm(gpx.se(1.0, 1.0), T, 2))
    got = tparams.leaves(multioutput.icm(gt.se(1.0, 1.0, **F64), T, 2))
    for g, w in zip(got, want):
        _close(g, w)


def _feed(monkeypatch, draws):
    """The port's next ``torch.randn`` calls return ``draws``, in order."""
    it = iter([_t(z) for z in draws])
    monkeypatch.setattr(torch, "randn", lambda *a, **k: next(it))


def test_posterior_draw_on_gpx_normals(ref, monkeypatch):
    """Per-output noise, a mask, shape (2,): gpx's draw on its own normals,
    which the port's generator is made to return."""
    d, o, _, _, tp = ref
    want, z = o["pdraw"]
    _feed(monkeypatch, [z])
    got = multioutput.posterior_draw(torch.Generator(), tp["pn"], _t(d["x"]),
                                     _t(d["Ym"]), _t(d["xs"]), shape=(2,),
                                     mask=d["mask"])
    assert got.shape == (2, 7, T)
    _close(got, want)


def test_draw_is_matrix_normal(ref):
    """An LMC draw: sum_q L_q Z_q Bh_q^T plus the noise, with L_q and B_q
    gpx's, Z_q the generator's (each (N, T), then the noise) and Bh_q the
    eigen square root of gpx's B_q."""
    d, o, _, _, tp = ref
    got = multioutput.draw(torch.Generator().manual_seed(1), tp["lmc"],
                           _t(d["x"]))
    gen = torch.Generator().manual_seed(1)
    want = 0.0
    for l, b in o["draw"]:   # torch's eigh: the port's eigenvector signs
        lam, q = (t.numpy() for t in torch.linalg.eigh(_t(b)))
        z = torch.randn((N, T), generator=gen, dtype=torch.float64).numpy()
        want = want + l @ z @ (q * np.sqrt(np.maximum(lam, 0.0))).T
    want = want + np.sqrt(0.1) * torch.randn(
        (N, T), generator=gen, dtype=torch.float64).numpy()
    _close(got, want)


def _at(ref, key, tree):
    """gpx's oracles with the port's ``tree`` in place of ``key``'s."""
    _, _, trees, fn, _ = ref
    return fn(dict(trees, **{key: jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(trees[key]),
        [jnp.asarray(t.numpy()) for t in tparams.leaves(tree)])}))


def _lbfgs_optimum(ref, res, key):
    """The port's optimum (converged: its unconstrained gradient norm below
    grad_tol = 1e-3): gpx's value there equal to the port's, and gpx's
    gradient, taken to the unconstrained space by the bijectors'
    derivatives, of norm below 1e-3 too."""
    value, grad = _at(ref, key, res.params)[key if key != "icm" else "kron"]
    np.testing.assert_allclose(float(res.value), float(value), rtol=1e-10)
    bijs = tparams.leaves(res.params.bijectors())
    u = tparams.leaves(tparams.unconstrain(res.params.bijectors(), res.params))
    g_u = [np.asarray(g) * torch.exp(b.log_det_jacobian(t)).numpy()
           for g, b, t in zip(jax.tree_util.tree_leaves(grad), bijs, u)]
    assert res.converged
    assert np.sqrt(sum(float(np.sum(g * g)) for g in g_u)) < 1e-3


def test_optimize_and_samplers(ref):
    """L-BFGS on the kron logML to gpx's stationary point; MH and NUTS run
    (a few draws, one chain) with finite draws whose logML is gpx's."""
    d, _, _, _, tp = ref
    x, Y = _t(d["x"]), _t(d["Y"])
    _lbfgs_optimum(ref, multioutput.optimize(tp["icm"], x, Y, steps=100),
                   "icm")
    for post in (multioutput.sample_mh(0, x, Y, tp["icm"], lambda p: 0.0, 4,
                                       n_chains=1),
                 multioutput.sample_nuts(0, x, Y, tp["icm"], lambda p: 0.0, 2,
                                         n_chains=1, warmup_iters=2,
                                         max_depth=2)):
        assert torch.isfinite(post.flat).all()
        last = tparams.unflatten(tp["icm"], [t[0, -1] for t in
                                             tparams.leaves(post.params)])
        _close(multioutput.log_marginal_likelihood(last, x, Y),
               _at(ref, "icm", last)["kron"][0])


# -- multioutput_iterative -----------------------------------------------------

@pytest.mark.parametrize("method", ["auto", "xla"])
def test_kron_matvec_ragged_widths(ref, method):
    """T R = 15 and 18 columns, a vector, and an LMC; both routes."""
    d, o, _, _, tp = ref
    x = _t(d["x"])
    mv = multioutput_iterative.kron_matvec(tp["icm"], x, nugget=1e-3,
                                           method=method)
    _close(mv(_t(d["v15"])), o["mv"][0])
    _close(mv(_t(d["v18"])), o["mv"][1])
    _close(mv(_t(d["v15"])[:, 0]), o["mv"][2])
    _close(multioutput_iterative.kron_matvec(
        tp["lmc"], x, nugget=1e-3, method=method)(_t(d["v18"])), o["mv"][3])


def test_kron_preconditioner(ref):
    """Rank 8 with White split out of the base kernel: apply, logdet, and
    the probes on gpx's Rademacher base. The pivoted factor's eigenbasis is
    unique up to signs, which the products cancel."""
    d, o, _, _, tp = ref
    pc = multioutput_iterative.kron_preconditioner(tp["icm"], _t(d["x"]), RANK,
                                                   nugget=1e-3)
    apply, logdet, probes, u = o["precond"]
    _close(pc.apply(_t(d["v15"])), apply, 1e-9)
    _close(pc.logdet, logdet)
    _close(pc.root(_t(u)), probes, 1e-9)
    with pytest.raises(ValueError):
        multioutput_iterative.kron_preconditioner(tp["lmc"], _t(d["x"]), 4)


def test_logml_iterative_on_gpx_probes(ref):
    """The estimator on gpx's probe and SLQ draws: value, every leaf's
    gradient, the CG iteration count (cg_tol 1e-10; 10 Lanczos steps).
    Within 1e-8: two CG runs meet the tolerance on different rounding.
    The preconditioned leg: its generator entry point runs (its pieces
    against gpx in test_kron_preconditioner)."""
    d, o, _, _, tp = ref
    probe, slq = o["noise"]
    res = multioutput_iterative._logml_value_and_grad_iterative(
        tp["icm"], _t(d["x"]), _t(d["Y"]), probe_noise=_t(probe),
        slq_noise=_t(slq), lanczos_iters=10, cg_tol=1e-10)
    want = o["iter"]
    _close(res.value, want.value, 1e-8)
    for g, w in zip(tparams.leaves(res.grads),
                    jax.tree_util.tree_leaves(want.grads)):
        _close(g, w, 1e-8)
    assert res.cg_converged and abs(res.cg_iters - int(want.cg_iters)) <= 1
    for rank in (0, RANK):
        out = multioutput_iterative.logml_value_and_grad_iterative(
            tp["icm"], _t(d["x"]), _t(d["Y"]), torch.Generator().manual_seed(0),
            n_probes=S, lanczos_iters=10, precond_rank=rank)
        assert torch.isfinite(out.value)
        assert all(torch.isfinite(g).all() for g in tparams.leaves(out.grads))
        np.testing.assert_allclose(float(out.value), float(want.value),
                                   rtol=0.05)


def test_fit_iterative(ref):
    """Preconditioned (rank 8): the mean through the cross matvec and the
    blocked variance (4 test points a block, the last padded), cg_tol
    1e-10: within 1e-8."""
    d, o, _, _, tp = ref
    f = multioutput_iterative.fit_iterative(
        tp["icm"], _t(d["x"]), _t(d["Y"]), _t(d["xs"]), cg_tol=1e-10,
        precond_rank=RANK, variance_block=4)
    want = o["fit_iter"]
    _close(f.mean, want.mean, 1e-8)
    _close(f.variance, want.variance, 1e-8)
    _close(f.interval(0.9), want.interval(0.9), 1e-8)
    assert f.cg_converged


# -- gridgp ----------------------------------------------------------------------

def test_grid_logml_fit_and_matvec(ref):
    """The 16 x 8 lattice (SE on 1-D, Matern 3/2 on 2-D): logML and its
    gradient through both axes' eigh, fit with and without variance, the
    masked fit by CG (cg_tol 1e-10; within 1e-8), the Kronecker matvec
    with a trailing axis, the lattice's coordinates."""
    d, o, _, _, tp = ref
    axes, Y = [_t(d["a1"]), _t(d["a2"])], _t(d["Yg"])
    _hold_vg(lambda p: gridgp.log_marginal_likelihood(p, axes, Y), tp["grid"],
             o["grid"])
    f = gridgp.fit(tp["grid"], axes, Y, _t(d["xg"]))
    _close(f.mean, o["gfit"][0])
    _close(f.variance, o["gfit"][1])
    assert gridgp.fit(tp["grid"], axes, Y.reshape(-1), _t(d["xg"]),
                      variance=False).variance.shape == (0,)
    _close(gridgp.fit(tp["grid"], axes, Y, _t(d["xg"]), mask=d["gmask"],
                      cg_tol=1e-10).mean, o["gfit_mask"], 1e-8)
    mv = gridgp.kron_matvec(tp["grid"], axes, nugget=1e-3)
    _close(mv(_t(d["vg"])[..., 0]), o["gmv"][0])
    _close(mv(_t(d["vg"])), o["gmv"][1])
    _close(gridgp.grid_coords(axes), o["coords"])
    assert gridgp.grid_shape(axes) == (16, 8)


def test_coregion_axis_grid(ref):
    """B (x) K on a (3 outputs) x 16 lattice: logML and its gradient in W,
    kappa and the SE leaves, and fit at (output id, x) points. The output
    axis is no Kernel, so its Gram never reaches the CUDA Gram kernel."""
    d, o, _, _, tp = ref
    axes = [gridgp.output_axis(T, **F64), _t(d["a1"])]
    Y = _t(d["Yc"])
    _hold_vg(lambda p: gridgp.log_marginal_likelihood(p, axes, Y),
             tp["cgrid"], o["cgrid"])
    f = gridgp.fit(tp["cgrid"], axes, Y, _t(d["xc"]))
    _close(f.mean, o["cfit"][0])
    _close(f.variance, o["cfit"][1])
    ca = tp["cgrid"].kernels[0]
    assert not isinstance(ca, Kernel) and ca.n_outputs == T
    _close(ca.gram(_t([[2.0], [0.0]]), _t([[1.0]])),
           (ca._b()[[2, 0]][:, [1]]).numpy())


def test_grid_draws(ref, monkeypatch):
    """``posterior_draw`` on gpx's normals, and ``draw`` as the per-axis
    eigen square root of gpx's per-axis Grams on the generator's normals
    (the lattice's, then the noise's)."""
    d, o, _, _, tp = ref
    axes = [_t(d["a1"]), _t(d["a2"])]
    roots = []
    for g in o["grams"]:   # torch's eigh: the port's eigenvector signs
        lam, q = (t.numpy() for t in torch.linalg.eigh(_t(g)))
        roots.append(q * np.sqrt(np.maximum(lam, 0.0) + 1e-8))
    got = gridgp.draw(torch.Generator().manual_seed(2), tp["grid"], axes,
                      shape=(2,))
    gen = torch.Generator().manual_seed(2)
    z = torch.randn((2, 16, 8), generator=gen, dtype=torch.float64).numpy()
    noise = torch.randn((2, 16, 8), generator=gen, dtype=torch.float64).numpy()
    want = np.einsum("ai,bj,sij->sab", *roots, z) + np.sqrt(0.2) * noise
    _close(got, want, 1e-9)
    want, z = o["gpdraw"]
    _feed(monkeypatch, [z])
    got = gridgp.posterior_draw(torch.Generator(), tp["grid"], axes,
                                _t(d["Yg"]), _t(d["xg"]), shape=(2,))
    _close(got, want)


def test_grid_optimize_and_mh(ref):
    """L-BFGS to gpx's stationary point; MH runs with finite draws; the
    logML with mesh= (a one-rank gloo mesh) is the logML."""
    d, _, _, _, tp = ref
    axes, Y = [_t(d["a1"]), _t(d["a2"])], _t(d["Yg"])
    _lbfgs_optimum(ref, gridgp.optimize(tp["grid"], axes, Y, steps=30),
                   "grid")
    post = gridgp.sample_mh(0, axes, Y, tp["grid"], lambda p: 0.0, 4,
                            n_chains=1)
    assert torch.isfinite(post.flat).all() and post.flat.shape[:2] == (1, 4)
    with one_rank_mesh() as mesh:
        sharded = gridgp.log_marginal_likelihood(tp["grid"], axes, Y,
                                                 mesh=mesh)
    np.testing.assert_allclose(
        float(sharded), float(gridgp.log_marginal_likelihood(tp["grid"],
                                                             axes, Y)),
        rtol=1e-12)


def test_failed_eigh_is_nan_and_size1_stride_passes():
    """A matrix of NaNs: ``ops.chol.eigh`` returns NaN (and a NaN
    gradient) where torch's raises, as gpx's eigh returns NaN; a NaN
    amplitude gives a NaN kron logML. numpy's ``x[:, None]`` has stride 0 on its size-1 axis,
    which the kernel wrappers' layout check accepts."""
    from gpx_torch.ops import _build, chol

    a = torch.full((3, 3), float("nan"), dtype=torch.float64,
                   requires_grad=True)
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.eigh(a)
    lam, q = chol.eigh(a)
    assert torch.isnan(lam).all() and torch.isnan(q).all()
    (g,) = torch.autograd.grad(lam.sum(), a)
    assert torch.isnan(g).all()
    x = torch.as_tensor(np.sort(np.linspace(0.0, 1.0, 6))[:, None],
                        dtype=torch.float32)
    assert x.stride(-1) == 0
    _build.require(x, "x", ndim=2, device=x.device)
    with pytest.raises(ValueError):
        _build.require(torch.zeros((3, 4)).T, "x", ndim=2,
                       device=torch.device("cpu"))
    p = multioutput.icm(gt.se(float("nan"), 1.0, **F64), T, 2)
    assert torch.isnan(multioutput.log_marginal_likelihood(
        p, torch.linspace(0.0, 1.0, 5, dtype=torch.float64),
        torch.zeros((5, T), dtype=torch.float64), method="kron"))


@pytest.mark.parametrize("name",
                         ["multioutput", "multioutput_iterative", "gridgp"])
def test_module_has_every_public_name(name):
    """Every function and class a gpx module defines, and its public
    number constants, exist in the port's module."""
    import importlib

    jmod = importlib.import_module(f"gpx.models.{name}")
    tmod = importlib.import_module(f"gpx_torch.models.{name}")
    want = [k for k, v in vars(jmod).items() if not k.startswith("__") and (
        getattr(v, "__module__", None) == jmod.__name__
        or (isinstance(v, (int, float, str)) and not k.startswith("_")))]
    assert want and not [k for k in want if not hasattr(tmod, k)]
