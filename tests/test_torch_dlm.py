"""The state-space models of the port (``dlm``, ``dlmgp``) against the JAX
package, in float64 on the CPU: ``polynomial(2) + seasonal(6, 2)``
(d_state 6) replicated over 3 sensors, T = 30 with NaN entries, and a
DLM-GP of 3 sensors. The Kalman filter (diagonal V, and the full V =
K(x, x) with missing entries), the RTS smoother, the forecast, the
conjugate filter and the replicated GP likelihood within 1e-10 of each
array's largest entry; FFBS, the variance draws, ``simulate``, the DLM
sampler's first Gibbs sweep and a few sweeps of the DLM-GP's on gpx's own
normals and uniforms, fed to the port's ``torch.randn`` and
``torch.rand`` (the DLM sampler's later sweeps against its own pieces).
gpx's oracles are jitted programs, compiled for compile time, one a gpx
call, in which
``jax.random.gamma(key, a)`` is ``a (1/2 + U(key))``: the same variates go
to the port's ``torch._standard_gamma``, so each variance draw holds its
posterior's concentration and scale, and no gamma sampler is compiled."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.distributions import Gamma
from gpx.distributions import InverseGamma as JIG
from gpx.models import dlm as jdlm
from gpx.models import dlmgp as jdg
from gpx_torch.distributions import InverseGamma
from gpx_torch.models import dlm, dlmgp

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
T, S, SWEEPS, AHEAD = 30, 3, 3, 5
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}
KEY = jax.random.PRNGKey(6)
PRIOR = (3.0, 0.5)      # InverseGamma(concentration, scale) for V and W


def _data():
    """The model's F and G, written out (polynomial(2): a level and a
    slope; seasonal(6, 2): two Fourier pairs), and T steps simulated from
    it with 10% of the entries NaN."""
    g = np.zeros((6, 6))
    g[:2, :2] = [[1.0, 1.0], [0.0, 1.0]]
    for h in (1, 2):
        c, s = np.cos(2.0 * np.pi * h / 6), np.sin(2.0 * np.pi * h / 6)
        g[2 * h:2 * h + 2, 2 * h:2 * h + 2] = [[c, s], [-s, c]]
    f = np.tile([1.0, 0.0, 1.0, 0.0, 1.0, 0.0], (S, 1))
    rng = np.random.default_rng(2)
    x = np.zeros(6)
    x[0], x[2] = 2.0, 1.0
    ys = []
    for _ in range(T):
        x = g @ x + np.sqrt(0.01) * rng.normal(size=6)
        ys.append(f @ x + np.sqrt(0.2) * rng.normal(size=S))
    ys = np.array(ys)
    ys_nan = np.where(rng.uniform(size=ys.shape) < 0.1, np.nan, ys)
    return dict(ys=ys_nan, v=np.array([0.2, 0.3, 0.25]), w=np.full(6, 0.02),
                m0=np.zeros(6), c0=np.eye(6) * 10.0,
                locs=rng.uniform(0.0, 3.0, (S, 2)), w_star=np.full(6, 0.05))


def _kern(se, white, **kw):
    return se(1.0, 1.5, **kw) + white(0.2, **kw)


def _ffbs_normals(key, d):
    return jax.vmap(lambda k: jax.random.normal(k, (d,)))(
        jax.random.split(key, T))


def _sweep_keys(key, n):
    """Each sweep's keys, as gpx's samplers split them."""
    return jax.vmap(lambda k: jax.random.split(k, n))(
        jax.random.split(key, SWEEPS))


def _unit(key, d):
    """The factor of the oracles' gamma variates, 1/2 + U(key), (d,)."""
    return 0.5 + jax.random.uniform(key, (d,))


def _gamma(key, a, shape=None, dtype=None):
    """``jax.random.gamma`` in the oracles: ``a (1/2 + U(key))``, a
    positive variate that carries its concentration."""
    return a * _unit(key, a.shape[0] if shape is None else shape[0])


def _jmodel():
    return jdlm.replicate_observations(
        jdlm.polynomial(2) + jdlm.seasonal(6, 2), S)


def _jprior(a=PRIOR[0], b=PRIOR[1]):
    return JIG(concentration=jnp.asarray(a), scale=jnp.asarray(b))


def _jit(fn, *args):
    return jax.jit(fn, compiler_options=_FAST_COMPILE)(*args)


def _oracles(jd):
    """gpx's outputs, one small program a call, every array an argument (no
    constants to fold): XLA's compile time grows faster than the program,
    and all of these in one program took 10 s to trace and compile on one
    core, cold."""
    model, prior = _jmodel(), _jprior()
    kern = _kern(gpx.se, gpx.white)

    def kalman(d, v, w):
        return jdlm.kalman_filter(model, d["ys"], v, w, d["m0"], d["c0"])

    def filters(d):
        # one scan for three (V, W): the diagonal V as a matrix, K(x, x),
        # and gpx's Gibbs start (I, 0.1 I)
        vs = jnp.stack([jnp.diag(d["v"]), kern.gram(d["locs"], nugget=1e-3),
                        jnp.eye(S)])
        ws = jnp.stack([d["w"], d["w"], jnp.full(6, 0.1)])
        out = jax.vmap(kalman, in_axes=(None, 0, 0))(d, vs, ws)
        return [jax.tree_util.tree_map(lambda a: a[i], out) for i in range(3)]

    def sweep(d, f, f_start, key):
        # FFBS without W on the filter; then the first Gibbs sweep from
        # gpx's start, as gibbs_sample makes it: FFBS with W (the Joseph
        # backward covariance), then the V and W draws at the states
        k0, k1, k2, k3 = jax.random.split(key, 4)
        xs = jdlm.ffbs(k1, model, f_start, jnp.full(6, 0.1))
        return dict(
            plain=jdlm.ffbs(k0, model, f), z_plain=_ffbs_normals(k0, 6),
            xs=xs, z=_ffbs_normals(k1, 6), u_v=_unit(k2, S), u_w=_unit(k3, 6),
            v=jdlm.sample_observation_variance(k2, prior, model, d["ys"], xs),
            w=jdlm.sample_system_variance(k3, prior, model, xs))

    o = {"model": _jit(lambda: (model.f, model.g))}
    o["filter"], o["filter_kxx"], o["filter_start"] = _jit(filters, jd)
    filt = o["filter"]
    o["smooth"] = _jit(lambda f: jdlm.smooth(model, f), filt)
    o["forecast"] = _jit(lambda d, f: jdlm.forecast(
        model, f.m[-1], f.c[-1], d["v"], d["w"], AHEAD), jd, filt)
    o["conj"] = _jit(lambda d: jdlm.conjugate_filter(
        model, d["ys"], d["w_star"], d["m0"], d["c0"], prior), jd)
    o["sweep"] = _jit(sweep, jd, filt, o["filter_start"], KEY)

    # -- the DLM-GP over the 3 sensors: a local level ---------------------
    params = gpx.Parameters(mean=gpx.zero(), kernel=kern)
    o["rlml"] = _jit(lambda d: jdg.replicated_log_marginal_likelihood(
        params, d["locs"], jnp.nan_to_num(d["ys"])), jd)
    level = jdlm.replicate_observations(jdlm.polynomial(1), S)

    def sim_noise(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (jax.random.normal(k1, (1,)), jax.random.normal(k2, (S,)),
                jax.random.normal(k3, (S,)))

    o["simulate"] = _jit(lambda d, k: (*jdg.simulate(
        k, level, params, d["locs"], jnp.asarray(0.01), jnp.array([0.05]),
        jnp.zeros(1), T), jax.vmap(sim_noise)(jax.random.split(k, T))), jd,
        jax.random.PRNGKey(3))
    template = gpx.Parameters(mean=gpx.zero(),
                              kernel=gpx.se(0.5, 1.0) + gpx.white(0.5))
    o["dlmgp_gibbs"] = _jit(lambda d, ys_gp, key: (jdg.gibbs_sample(
        key, level, ys_gp, d["locs"], template,
        _log_prior_kernel(Gamma, jnp.asarray), _jprior(3.0, 0.1),
        jnp.zeros(1), jnp.eye(1) * 10.0, SWEEPS, proposal_scale=0.3),
        jax.vmap(lambda k: (_ffbs_normals(k[0], 1),
                            jax.random.normal(k[1], (3,)),
                            jax.random.uniform(k[2]),
                            _unit(k[3], 1)))(_sweep_keys(key, 4))),
        jd, o["simulate"][1], KEY)
    o["grid"] = jdg.grid_locations((0.0, 1.0), (-1.0, 2.0), 3, 4)
    return o


def _log_prior_kernel(gamma, const):
    def log_prior(kern):
        pr = gamma(concentration=const(2.0), rate=const(2.0))
        c0, c1 = kern.kernels
        return pr.logpdf(c0.h) + pr.logpdf(c0.sigma) + pr.logpdf(c1.sigma)

    return log_prior


@pytest.fixture(scope="module")
def ref():
    d = _data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "gamma", _gamma)
        o = _oracles({k: jnp.asarray(v) for k, v in d.items()})
    return d, jax.tree_util.tree_map(np.asarray, o)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=1e-10):
    """Within ``rtol`` of the array's largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _model(sensors=S, order=2):
    base = dlm.polynomial(order, **F64)
    if order == 2:
        base = base + dlm.seasonal(6, 2, **F64)
    return dlm.replicate_observations(base, sensors)


def _prior(a=PRIOR[0], b=PRIOR[1]):
    return InverseGamma(concentration=torch.tensor(a, **F64),
                        scale=torch.tensor(b, **F64))


def _feed(monkeypatch, name, draws):
    """The port's next ``torch.<name>`` calls return ``draws``, in
    order."""
    it = iter([_t(z) for z in draws])
    monkeypatch.setattr(torch, name, lambda *a, **k: next(it))


def _feed_gamma(monkeypatch, units):
    """The port's next ``torch._standard_gamma(a)`` calls return ``a *
    units[i]``, as the oracles' gamma does."""
    it = iter([_t(u) for u in units])
    monkeypatch.setattr(torch, "_standard_gamma", lambda a, **k: a * next(it))


def _filter(d, v):
    return dlm.kalman_filter(_model(), _t(d["ys"]), v, _t(d["w"]),
                             _t(d["m0"]), _t(d["c0"]))


def test_model_matrices(ref):
    """polynomial + seasonal, replicated: F and G as gpx's."""
    _, o = ref
    model = _model()
    _close(model.f, o["model"][0])
    _close(model.g, o["model"][1])
    assert dlm.polynomial(1, **F64).g.shape == (1, 1)


@pytest.mark.parametrize("case", ["diagonal", "kxx"])
def test_kalman_filter(ref, case):
    """Every output of the filter, with NaN entries, under a diagonal V and
    under the full V = K(x, x) (the DLM-GP's; missing entries' cross
    covariances zeroed)."""
    d, o = ref
    v = _t(d["v"]) if case == "diagonal" else _kern(gt.se, gt.white, **F64) \
        .gram(_t(d["locs"]), nugget=1e-3)
    got = _filter(d, v)
    want = o["filter" if case == "diagonal" else "filter_kxx"]
    for g, w in zip(got, want):
        _close(g, w)


def test_smooth_forecast_conjugate(ref):
    """The RTS smoother, a 5-step forecast and the conjugate filter (every
    output, the Student-t scales among them)."""
    d, o = ref
    filt = _filter(d, _t(d["v"]))
    for g, w in zip(dlm.smooth(_model(), filt), o["smooth"]):
        _close(g, w)
    for g, w in zip(dlm.forecast(_model(), filt.m[-1], filt.c[-1], _t(d["v"]),
                                 _t(d["w"]), AHEAD), o["forecast"]):
        _close(g, w)
    got = dlm.conjugate_filter(_model(), _t(d["ys"]), _t(d["w_star"]),
                               _t(d["m0"]), _t(d["c0"]), _prior())
    for g, w in zip(got, o["conj"]):
        _close(g, w)


def _start(d):
    """gpx's Gibbs start (V, W) = (1, 0.1) and the filter there."""
    v, w = torch.ones(S, **F64), torch.full((6,), 0.1, **F64)
    return v, w, dlm.kalman_filter(_model(), _t(d["ys"]), v, w, _t(d["m0"]),
                                   _t(d["c0"]))


def test_ffbs_and_variance_draws(ref, monkeypatch):
    """FFBS without W (the textbook backward covariance) on gpx's normals;
    then the first Gibbs sweep's pieces, each from gpx's inputs: the
    filter at gpx's start (V, W) = (1, 0.1), FFBS with W (the Joseph
    backward covariance) and the V and W draws on gpx's normals and
    gamma variates."""
    d, o = ref
    model = _model()
    sw = o["sweep"]
    _feed(monkeypatch, "randn", [sw["z_plain"]])
    _close(dlm.ffbs(torch.Generator(), model, _filter(d, _t(d["v"]))),
           sw["plain"])

    xs, v, w = sw["xs"], sw["v"], sw["w"]
    _, w0, filt = _start(d)
    for g, want in zip(filt, o["filter_start"]):
        _close(g, want)
    _feed(monkeypatch, "randn", [sw["z"]])
    _close(dlm.ffbs(torch.Generator(), model, filt, w0), xs)
    _feed_gamma(monkeypatch, [sw["u_v"], sw["u_w"]])
    _close(dlm.sample_observation_variance(torch.Generator(), _prior(),
                                           model, _t(d["ys"]), _t(xs)), v)
    _close(dlm.sample_system_variance(torch.Generator(), _prior(), model,
                                      _t(xs)), w)


def test_dlm_gibbs_on_gpx_noise(ref, monkeypatch):
    """Three FFBS-within-Gibbs sweeps, the first on gpx's noise: its
    states, V and W are gpx's first sweep (the pieces held above), and
    each later sweep, on numpy noise, is the port's filter, FFBS and
    variance draws chained from the sweep before."""
    d, o = ref
    sw = o["sweep"]
    rng = np.random.default_rng(4)
    noise = [(sw["z"], sw["u_v"], sw["u_w"])] + [
        (rng.normal(size=(T, 6)), 0.5 + rng.uniform(size=S),
         0.5 + rng.uniform(size=6)) for _ in range(SWEEPS - 1)]
    _feed(monkeypatch, "randn", [z for z, _, _ in noise])
    _feed_gamma(monkeypatch, [u for _, u_v, u_w in noise for u in (u_v, u_w)])
    model, ys, m0, c0 = _model(), _t(d["ys"]), _t(d["m0"]), _t(d["c0"])
    got = dlm.gibbs_sample(0, model, ys, _prior(), _prior(), m0, c0, SWEEPS)
    for g, w in zip((got.states[0], got.v[0], got.w[0]),
                    (sw["xs"], sw["v"], sw["w"])):
        _close(g, w)
    v, w, _ = _start(d)
    for i, (z, u_v, u_w) in enumerate(noise):
        _feed(monkeypatch, "randn", [z])
        _feed_gamma(monkeypatch, [u_v, u_w])
        filt = dlm.kalman_filter(model, ys, v, w, m0, c0)
        xs = dlm.ffbs(torch.Generator(), model, filt, w)
        v = dlm.sample_observation_variance(torch.Generator(), _prior(),
                                            model, ys, xs)
        w = dlm.sample_system_variance(torch.Generator(), _prior(), model,
                                       xs)
        for g, want in zip((got.states[i], got.v[i], got.w[i]), (xs, v, w)):
            _close(g, want.numpy())


def test_replicated_logml_and_grid(ref):
    """T replicates of the GP over the sensors (one factor, one multi-RHS
    solve), and grid_locations."""
    d, o = ref
    p = gt.Parameters(mean=gt.zero(), kernel=_kern(gt.se, gt.white, **F64))
    _close(dlmgp.replicated_log_marginal_likelihood(
        p, _t(d["locs"]), _t(np.nan_to_num(d["ys"]))), o["rlml"])
    _close(dlmgp.grid_locations((0.0, 1.0), (-1.0, 2.0), 3, 4, **F64),
           o["grid"])


def test_simulate_and_dlmgp_gibbs(ref, monkeypatch):
    """simulate on gpx's normals (the state, GP and observation blocks);
    three joint Gibbs sweeps on gpx's draws from its simulated data: the
    kernel draws, W, the states and the MH accept rate."""
    d, o = ref
    level = _model(order=1)
    p = gt.Parameters(mean=gt.zero(), kernel=_kern(gt.se, gt.white, **F64))
    states, ys, noise = o["simulate"]
    _feed(monkeypatch, "randn", noise)
    got = dlmgp.simulate(torch.Generator(), level, p, _t(d["locs"]),
                         torch.tensor(0.01, **F64), torch.tensor([0.05], **F64),
                         torch.zeros(1, **F64), T)
    _close(got[0], states)
    _close(got[1], ys)

    want, (z, steps, uniforms, u_w) = o["dlmgp_gibbs"]
    _feed(monkeypatch, "randn", [a for i in range(SWEEPS)
                                 for a in (z[i], steps[i])])
    _feed(monkeypatch, "rand", uniforms)
    _feed_gamma(monkeypatch, u_w)
    template = gt.Parameters(mean=gt.zero(), kernel=gt.se(0.5, 1.0, **F64)
                             + gt.white(0.5, **F64))
    res = dlmgp.gibbs_sample(
        0, level, _t(ys), _t(d["locs"]), template,
        _log_prior_kernel(gt.distributions.Gamma,
                          lambda v: torch.tensor(v, **F64)),
        _prior(3.0, 0.1), torch.zeros(1, **F64), torch.eye(1, **F64) * 10.0,
        SWEEPS, proposal_scale=0.3)
    for g, w in zip(res[:3], want[:3]):
        _close(g, w)
    # gpx's accept rate is float32 (an int32 count over an int)
    assert round(float(res.accept_rate) * SWEEPS) == round(
        float(want.accept_rate) * SWEEPS)
    assert 0.0 < float(res.accept_rate) < 1.0


@pytest.mark.parametrize("name", ["dlm", "dlmgp"])
def test_module_has_every_public_name(name):
    """Every function and class a gpx module defines exists in the port's."""
    jmod = importlib.import_module(f"gpx.models.{name}")
    tmod = importlib.import_module(f"gpx_torch.models.{name}")
    want = [k for k, v in vars(jmod).items() if not k.startswith("__")
            and getattr(v, "__module__", None) == jmod.__name__]
    assert want and not [k for k in want if not hasattr(tmod, k)]
