"""The sparse models of the port (``sparse``, ``svgp``, ``svgp_mo``)
against the JAX package, in float64 on the CPU at N = 64, M = 12, T = 3,
Q = 2: every value, and autograd's gradient in every parameter leaf, the
inducing points and the variational state, within 1e-10 of each array's
largest entry; ``svgp.train`` and ``svgp_mo.train`` step for step against
an eager ``optax.adam`` loop over one jitted gpx value-and-grad step on the
same minibatch indices (the port's index draw patched); the minibatch
gradients are that step's, in the unconstrained space, at a random
variational state. The inducing points sit on data points, so every Kuf
holds exact zero distances (Matérn's gradient in z must stay finite
there). gpx's oracles are one jitted program, compiled for compile time:
one Adam step of both trainers, which also returns the values."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx import params as jparams
from gpx.models import gp as jgp
from gpx.models import sparse as jsparse
from gpx.models import svgp as jsvgp
from gpx.models import svgp_mo as jmo
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy
from gpx_torch.models import gp, sparse, svgp, svgp_mo
from tests.torch_parallel_ranks import one_rank_mesh

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
N, M, T, B, STEPS = 64, 12, 3, 16, 6
NOISE = 0.3
MNOISE = np.array([0.2, 0.3, 0.4])
BETA = np.array([0.2, 0.1])
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


def _data():
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(-6.0, 6.0, (N, 1)), axis=0)
    phase = rng.uniform(0.0, 2.0, T)
    d = dict(
        x=x, y=1.5 * np.sin(x[:, 0]) + 0.3 * rng.normal(size=N),
        Y=1.5 * np.sin(x + phase[None, :]) + 0.3 * rng.normal(size=(N, T)),
        z=x[:: N // M][:M], xs=np.linspace(-7.0, 7.0, 20)[:, None],
        mu=0.3 * rng.normal(size=M), c_raw=0.2 * rng.normal(size=(M, M)),
        mmu=0.3 * rng.normal(size=(2, M)),
        mc_raw=0.2 * rng.normal(size=(2, M, M)),
        w=rng.normal(size=(T, 2)) * 0.6, mask=rng.uniform(size=(N, T)) > 0.2)
    idx = [rng.choice(N, B, replace=False) for _ in range(STEPS + 1)]
    return d, idx


def _jparams():
    return gpx.Parameters(mean=gpx.plane(jnp.asarray(BETA)),
                          kernel=gpx.se(1.3, 1.7) + gpx.matern(0.4, 1.5, 2.0))


def _jmo(w):
    return jmo.mo_svgp([gpx.se(1.2, 1.5), gpx.matern(0.8, 1.5, 2.0)], T,
                       w=jnp.asarray(w))


def _tparams():
    template = gt.Parameters(mean=gt.plane(BETA, **F64),
                             kernel=gt.se(1.0, 1.0, **F64)
                             + gt.matern(1.0, 1.5, 1.0, **F64))
    return params_from_numpy(template,
                             jax.tree_util.tree_leaves(_jparams()))


def _tmo(w):
    return svgp_mo.mo_svgp([gt.se(1.2, 1.5, **F64),
                            gt.matern(0.8, 1.5, 2.0, **F64)], T, w=w)


def _oracles(jp, jm, d):
    x, y, z = d["x"], d["y"], d["z"]
    o = {}
    o["elbo"] = jax.value_and_grad(
        lambda p, zz: jsparse.elbo(p, zz, x, y, noise=NOISE),
        argnums=(0, 1))(jp, z)
    fs = jsparse.fit(jp, z, x, y, d["xs"], noise=NOISE)
    o["sfit"] = (fs.mean, fs.variance)
    st = jsvgp.SVGPState(d["mu"], d["c_raw"])
    o["kl"] = jsvgp.kl(st)
    fv = jsvgp.fit(jp, z, st, d["xs"], noise=NOISE)
    o["vfit"] = (fv.mean, fv.variance)
    mst = jmo.MoSVGPState(d["mmu"], d["mc_raw"])
    o["mkl"] = jmo.kl(mst)
    mf = jmo.fit(jm, z, mst, d["xs"], noise=jnp.asarray(MNOISE))
    o["mfit"] = (mf.mean, mf.variance, mf.interval(0.9))
    o["moments"] = jmo._latent_moments(jm, z, mst, d["xs"])
    # the bound at z = x and the exact logML with the noise as White
    smooth = gpx.Parameters(mean=gpx.zero(), kernel=gpx.se(1.3, 1.7))
    exact = gpx.Parameters(mean=gpx.zero(),
                           kernel=gpx.se(1.3, 1.7) + gpx.white(NOISE))
    o["tight"] = (jsparse.elbo(smooth, x, x, y, noise=NOISE + 1e-6),
                  jgp.log_marginal_likelihood(exact, x, y, nugget=1e-6))
    return o


LR = 0.05


def _losses(jp, jm, d):
    """gpx's training losses of ``svgp.train`` and ``svgp_mo.train`` on the
    minibatch of rows ``i`` (their ``loss_fn`` with the draw taken out)."""
    x, y, Y, mask = d["x"], d["y"], d["Y"], d["mask"]
    bs, bm = jp.bijectors(), jm.bijectors()

    def svgp_loss(tr, i):
        p = jparams.constrain(bs, tr["params"])
        return -jsvgp.elbo_minibatch(p, tr["z"], tr["state"], x[i], y[i],
                                     n_total=N, noise=jnp.exp(tr["log_noise"]))

    def mo_loss(tr, i):
        p = jparams.constrain(bm, tr["params"])
        return -jmo.elbo_minibatch(p, tr["z"], tr["state"], x[i], Y[i],
                                   n_total=N, noise=jnp.exp(tr["log_noise"]),
                                   mask_b=mask[i])

    return svgp_loss, mo_loss


def _step(losses, jp, jm, jd):
    """One ``optax.adam`` step of each loss: ``(-loss, grad, tree, state)``
    per model, the svgp ELBO with gpx's ``GPX_SVGP_SOLVER=inv``, and the
    value oracles (one program, so one compile)."""
    adam = optax.adam(LR)

    def step(trs, states, idxs):
        out = []
        for loss, tr, st, i in zip(losses, trs, states, idxs):
            value, grad = jax.value_and_grad(loss)(tr, i)
            updates, st = adam.update(grad, st, tr)
            out.append((-value, grad, optax.apply_updates(tr, updates), st))
        os.environ["GPX_SVGP_SOLVER"] = "inv"   # read while this traces
        try:
            inv = -losses[0](trs[0], idxs[0])
        finally:
            del os.environ["GPX_SVGP_SOLVER"]
        return out, inv, _oracles(jp, jm, jd)

    return adam, jax.jit(step, compiler_options=_FAST_COMPILE)


def _start(jp, jm, d, random_state):
    """The trainable trees: gpx's ``train`` start (zero state), or the
    random state of the gradient checks."""
    if random_state:
        st = jsvgp.SVGPState(d["mu"], d["c_raw"])
        mst = jmo.MoSVGPState(d["mmu"], d["mc_raw"])
    else:
        st = jsvgp.init_state(M, jnp.float64)
        mst = jmo.init_state(2, M, jnp.float64)
    trs = ({"state": st, "params": jparams.unconstrain(jp.bijectors(), jp),
            "z": d["z"], "log_noise": jnp.log(NOISE)},
           {"state": mst, "params": jparams.unconstrain(jm.bijectors(), jm),
            "z": d["z"], "log_noise": jnp.log(jnp.asarray(MNOISE))})
    # strong types throughout, as the updated trees come back: one trace
    return jax.tree_util.tree_map(lambda a: jnp.array(a, jnp.float64), trs)


@pytest.fixture(scope="module")
def ref():
    d, idx = _data()
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    jp, jm = _jparams(), _jmo(d["w"])
    adam, step = _step(_losses(jp, jm, jd), jp, jm, jd)
    trs = _start(jp, jm, jd, random_state=True)
    i0 = jnp.asarray(idx[0])
    out, inv, o = step(trs, tuple(adam.init(t) for t in trs), (i0, i0))
    o["mb_inv"] = inv
    o["grad"] = [(value, grad) for value, grad, _, _ in out]
    trs = _start(jp, jm, jd, random_state=False)
    states = tuple(adam.init(t) for t in trs)
    o["trace"] = ([], [])
    for i in idx[1:]:
        out, _, _ = step(trs, states, (jnp.asarray(i),) * 2)
        trs = tuple(t for _, _, t, _ in out)
        states = tuple(s for _, _, _, s in out)
        for trace, (value, _, _, _) in zip(o["trace"], out):
            trace.append(value)
    o["trained"] = trs
    return d, idx, jax.tree_util.tree_map(np.asarray, o)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-10):
    """Within ``rtol`` of the array's largest entry (some entries are 0)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _close_leaves(got_tree, want_tree, rtol=1e-10):
    got = tparams.leaves(got_tree) if not isinstance(got_tree, (list, tuple)) \
        else got_tree
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, rtol)


def _grads(value, *inputs):
    return torch.autograd.grad(value, inputs)


def _with_grad(*trees):
    out = []
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            out.append(tree.clone().requires_grad_())
        else:
            out.append(tparams.unflatten(tree, [
                t.clone().requires_grad_() for t in tparams.leaves(tree)]))
    return out


def test_sgpr_elbo_and_gradient(ref):
    d, _, o = ref
    p, z = _with_grad(_tparams(), _t(d["z"]))
    value = sparse.elbo(p, z, _t(d["x"]), _t(d["y"]), noise=NOISE)
    (want_v, (want_p, want_z)) = o["elbo"]
    _close(value, want_v)
    g = _grads(value, *tparams.leaves(p), z)
    _close_leaves(list(g[:-1]), want_p)
    assert np.isfinite(g[-1].numpy()).all()
    _close(g[-1], want_z)


def test_sgpr_fit(ref):
    d, _, o = ref
    s = sparse.fit(_tparams(), _t(d["z"]), _t(d["x"]), _t(d["y"]),
                   _t(d["xs"]), noise=NOISE)
    _close(s.mean, o["sfit"][0])
    _close(s.variance, o["sfit"][1])
    assert s.x.shape == (20, 1)


def test_sgpr_bound_is_tight_at_z_eq_x(ref):
    """gpx's identity (tests/test_sparse.py): the bound at z = x equals the
    exact logML with the noise as a White term, on the port's side too;
    both against gpx's numbers."""
    d, _, o = ref
    x, y = _t(d["x"]), _t(d["y"])
    tight = sparse.elbo(gt.Parameters(mean=gt.zero(),
                                      kernel=gt.se(1.3, 1.7, **F64)),
                        x, x, y, noise=NOISE + 1e-6)
    exact = gp.log_marginal_likelihood(
        gt.Parameters(mean=gt.zero(), kernel=gt.se(1.3, 1.7, **F64)
                      + gt.white(NOISE, **F64)), x, y, nugget=1e-6)
    _close(tight, o["tight"][0])
    _close(exact, o["tight"][1])
    np.testing.assert_allclose(float(tight), float(exact), rtol=1e-6)


def test_sgpr_failed_factor_is_nan_in_float32():
    """Coincident inducing points under a large amplitude: in float32,
    1e4 + JITTER_F32 rounds to 1e4 and Kuu is exactly singular; the bound
    is NaN, as gpx's failed factor gives, and nothing raises."""
    f32 = dict(device="cpu", dtype=torch.float32)
    p = gt.Parameters(mean=gt.zero(), kernel=gt.se(1e4, 2.0, **f32))
    x = torch.linspace(-1.0, 1.0, 16, dtype=torch.float32)[:, None]
    z = torch.zeros((4, 1), dtype=torch.float32)
    assert sparse._jitter(torch.float32) == jsparse._jitter(jnp.float32)
    assert sparse._jitter(torch.float64) == jsparse._jitter(jnp.float64)
    assert torch.isnan(sparse.elbo(p, z, x, torch.zeros(16), noise=0.1))


def test_init_inducing_draws_distinct_rows():
    x = torch.arange(40, dtype=torch.float64)[:, None]
    z = sparse.init_inducing(torch.Generator().manual_seed(3), x, 12)
    assert z.shape == (12, 1) and len(set(z[:, 0].tolist())) == 12


def _unconstrained_value(p, z, state, log_noise, elbo):
    """``(value, [every input's gradient tensor])`` of ``elbo`` at the
    unconstrained leaves of ``p``, as gpx's ``train`` differentiates."""
    bijs = p.bijectors()
    u = tparams.unconstrain(bijs, p)
    ls = [t.clone().requires_grad_() for t in tparams.leaves(u)]
    z, log_noise = z.clone().requires_grad_(), log_noise.clone().requires_grad_()
    st = type(state)(*(t.clone().requires_grad_() for t in state))
    value = elbo(tparams.constrain(bijs, tparams.unflatten(u, ls)), z, st,
                 torch.exp(log_noise))
    return value, torch.autograd.grad(value, [*ls, z, *st, log_noise])


def _hold_step_grad(value, grads, want):
    """The ELBO and its gradient against gpx's step (whose loss is -ELBO)."""
    want_v, want_g = want
    want_g = jax.tree_util.tree_map(np.negative, want_g)
    _close(value, want_v)
    k = len(jax.tree_util.tree_leaves(want_g["params"]))
    _close_leaves(list(grads[:k]), want_g["params"])
    _close(grads[k], want_g["z"])
    _close(grads[k + 1], want_g["state"].mu)
    _close(grads[k + 2], want_g["state"].c_raw)
    _close(grads[k + 3], want_g["log_noise"])


@pytest.mark.parametrize("solver", ["solve", "inv"])
def test_svgp_elbo_minibatch_and_gradient(ref, solver):
    """The minibatch ELBO at a random state and its gradient in every
    unconstrained leaf, z, the state and the log noise (``solver="inv"``:
    gpx's ``GPX_SVGP_SOLVER=inv``, the value)."""
    d, idx, o = ref
    i = torch.as_tensor(idx[0])
    x, y = _t(d["x"])[i], _t(d["y"])[i]
    state = svgp.SVGPState(_t(d["mu"]), _t(d["c_raw"]))

    def elbo(p, z, st, s2):
        return svgp.elbo_minibatch(p, z, st, x, y, n_total=N, noise=s2,
                                   solver=solver)

    value, grads = _unconstrained_value(
        _tparams(), _t(d["z"]), state,
        torch.log(torch.tensor(NOISE, dtype=torch.float64)), elbo)
    if solver == "inv":
        _close(value, o["mb_inv"])
        return
    assert np.isfinite(grads[len(grads) - 4].numpy()).all()  # z
    _hold_step_grad(value, grads, o["grad"][0])


def test_svgp_kl_fit_and_state(ref):
    d, _, o = ref
    st = svgp.SVGPState(_t(d["mu"]), _t(d["c_raw"]))
    _close(svgp.kl(st), o["kl"])
    f = svgp.fit(_tparams(), _t(d["z"]), st, _t(d["xs"]), noise=NOISE)
    _close(f.mean, o["vfit"][0])
    _close(f.variance, o["vfit"][1])
    s0 = svgp.init_state(M, torch.float64, device="cpu")
    assert float(svgp.kl(s0)) == 0.0 and s0.c_raw.shape == (M, M)
    with pytest.raises(ValueError):
        svgp._whitened_features(_tparams(), _t(d["z"]), _t(d["xs"]),
                                solver="qr")


def _patch_indices(monkeypatch, idx):
    draws = iter([torch.as_tensor(i) for i in idx[1:]])
    monkeypatch.setattr(svgp, "_batch_indices",
                        lambda gen, n, b, device: next(draws))


def _hold_trajectory(res, trace, tr, template):
    params, z, state, noise, elbos = res
    _close(elbos, np.asarray(trace))
    _close_leaves(params, jparams.constrain(template.bijectors(),
                                            tr["params"]))
    _close(z, tr["z"])
    for got, want in zip(state, tr["state"]):
        _close(got, want)
    _close(noise, np.exp(tr["log_noise"]))


def test_svgp_train_matches_optax_step_for_step(ref, monkeypatch):
    """6 Adam steps (lr 0.05, batch 16) over the state, every hyperparameter
    (unconstrained), z and the log noise; each step's ELBO and the final
    trees."""
    d, idx, o = ref
    _patch_indices(monkeypatch, idx)
    res = svgp.train(0, _tparams(), _t(d["z"]), _t(d["x"]), _t(d["y"]),
                     noise=NOISE, batch_size=B, steps=STEPS, learning_rate=LR,
                     train_noise=True)
    _hold_trajectory(res, o["trace"][0], o["trained"][0], _jparams())
    # data-parallel over a one-rank gloo mesh: the same trajectory
    _patch_indices(monkeypatch, idx)
    with one_rank_mesh() as mesh:
        res = svgp.train(0, _tparams(), _t(d["z"]), _t(d["x"]), _t(d["y"]),
                         noise=NOISE, batch_size=B, steps=STEPS,
                         learning_rate=LR, train_noise=True, mesh=mesh)
    _hold_trajectory(res, o["trace"][0], o["trained"][0], _jparams())


def test_svgp_mo_elbo_minibatch_and_gradient(ref):
    """Masked minibatch, per-output noise, a random state: the value and
    its gradient in every unconstrained kernel leaf and W, z, both state
    stacks and the log noise."""
    d, idx, o = ref
    i = torch.as_tensor(idx[0])
    x, Y = _t(d["x"])[i], _t(d["Y"])[i]
    mask = torch.as_tensor(d["mask"])[i]
    state = svgp_mo.MoSVGPState(_t(d["mmu"]), _t(d["mc_raw"]))

    def elbo(p, z, st, s2):
        return svgp_mo.elbo_minibatch(p, z, st, x, Y, n_total=N, noise=s2,
                                      mask_b=mask)

    value, grads = _unconstrained_value(_tmo(d["w"]), _t(d["z"]), state,
                                        torch.log(_t(MNOISE)), elbo)
    _hold_step_grad(value, grads, o["grad"][1])


def test_svgp_mo_fit_kl_and_moments(ref):
    d, _, o = ref
    st = svgp_mo.MoSVGPState(_t(d["mmu"]), _t(d["mc_raw"]))
    p = _tmo(d["w"])
    f = svgp_mo.fit(p, _t(d["z"]), st, _t(d["xs"]), noise=_t(MNOISE))
    for got, want in zip((f.mean, f.variance, f.interval(0.9)), o["mfit"]):
        _close(got, want)
    _close(svgp_mo.kl(st), o["mkl"])
    for got, want in zip(svgp_mo._latent_moments(p, _t(d["z"]), st,
                                                 _t(d["xs"])), o["moments"]):
        _close(got, want)
    assert p.n_latent == 2 and p.n_outputs == T
    dflt = jax.tree_util.tree_leaves(jmo.mo_svgp(
        [gpx.se(1.2, 1.5), gpx.matern(0.8, 1.5, 2.0)], T))
    _close(svgp_mo.mo_svgp([gt.se(1.2, 1.5, **F64),
                            gt.matern(0.8, 1.5, 2.0, **F64)], T).w, dflt[-1])


def test_svgp_mo_train_matches_optax_step_for_step(ref, monkeypatch):
    """6 Adam steps with 20% of the entries masked and per-output noise
    trained; each step's ELBO and the final trees."""
    d, idx, o = ref
    _patch_indices(monkeypatch, idx)
    res = svgp_mo.train(0, _tmo(d["w"]), _t(d["z"]), _t(d["x"]), _t(d["Y"]),
                        noise=_t(MNOISE), batch_size=B, steps=STEPS,
                        learning_rate=LR, train_noise=True, mask=d["mask"])
    _hold_trajectory(res, o["trace"][1], o["trained"][1], _jmo(d["w"]))


@pytest.mark.parametrize("name", ["sparse", "svgp", "svgp_mo"])
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
