"""The port's matrix-free path against the JAX package, on the CPU: the
plain versions of the two matvec kernels against gpx's XLA route (float64)
and its Pallas kernels (interpret mode, float32), the torch route's
hyperparameter gradient, CG, Lanczos and SLQ, the Woodbury preconditioner,
and both entry points on gpx's own noise, in float64 at n <= 300. Every
gpx result comes from one jitted program, run once for the module."""

from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpx
import gpx_torch as gt
from gpx.models import gp_iterative as jgi
from gpx.ops import pallas_matvec as jpm
from gpx_torch import params as tparams
from gpx_torch.convert import params_from_numpy
from gpx_torch.models import gp_iterative as gi
from gpx_torch.ops import matvec as tmv
from gpx_torch.ops.cuda_matvec import _cross_matvec_torch, _gram_matvec_torch
from tests.torch_parallel_ranks import one_rank_mesh

torch.set_num_threads(1)
F64 = dict(device="cpu", dtype=torch.float64)
F32 = dict(device="cpu", dtype=torch.float32)
N = 160
KEY = jax.random.PRNGKey(5)        # the entry points' key
PC_KEY = jax.random.PRNGKey(3)     # the preconditioner's sample
SLQ_KEY = jax.random.PRNGKey(9)    # stand-alone SLQ
OPTS = dict(n_probes=8, lanczos_iters=24, cg_tol=1e-8)


def _t(a):
    return torch.as_tensor(np.array(a))


def _spd(rng, n, cond):
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (q * np.geomspace(1.0, cond, n)) @ q.T


def _data(rng):
    d = dict(
        x=np.sort(rng.uniform(-8, 8, size=(N, 1)), axis=0),
        y=rng.normal(size=N), xs=np.linspace(-8, 8, 40)[:, None],
        v=rng.normal(size=(N, 3)),
        # a cross product at D = 2 with duplicates across the sets
        x1=rng.uniform(-5, 5, size=(96, 2)), v2=rng.normal(size=(200, 3)),
        # the gradient contraction's vectors
        a=rng.normal(size=N), w=rng.normal(size=(N, 4)), u=rng.normal(size=(N, 4)),
        pv=rng.normal(size=(N, 2)),
        m_cg=_spd(rng, 80, 100.0), b_cg=rng.normal(size=(80, 3)),
        m_l=_spd(rng, 60, 50.0), z_l=rng.normal(size=(60, 3)),
        m_p=_spd(rng, 70, 200.0), z_p=rng.normal(size=(70, 4)),
        z_s=rng.normal(size=(3, 2)),
        # float32 inputs of the Pallas kernels (n = 256, bt = 128)
        x_pl=rng.uniform(-8, 8, size=(256, 1)).astype(np.float32),
        x1_pl=rng.uniform(-8, 8, size=(128, 1)).astype(np.float32),
        v_pl=rng.normal(size=(256, 2)).astype(np.float32))
    d["x2"] = np.concatenate([d["x1"][:10], rng.uniform(-5, 5, size=(190, 2))])
    d["b_cg"][:, 1] *= 1e-4   # this column converges first
    return d


def _per_key_rademacher(key, n, s):
    """gpx's per-probe draws, ``rademacher(k, (n,))`` over ``split(key, s)``,
    as columns; one vmapped draw compiles once where a loop compiles s."""
    return jax.vmap(lambda k: jax.random.rademacher(k, (n,), dtype=jnp.float64),
                    out_axes=1)(jax.random.split(key, s))


def _oracles(kj, jp, d):
    """Every gpx result the tests compare with."""
    x, y = d["x"], d["y"]
    o = {"gram": jpm.gram_matvec(kj, x, d["v"], nugget=1e-3)}

    def contraction(kern):
        quad = 0.5 * d["a"] @ jpm._gram_matvec_xla(kern, x, d["a"][:, None],
                                                    1e-3)[:, 0]
        tr = jnp.mean(jnp.sum(d["u"] * jpm._gram_matvec_xla(kern, x, d["w"], 1e-3),
                              axis=0))
        return quad - 0.5 * tr

    o["contraction"] = jax.grad(contraction)(kj)
    for form, pick in (("matrix", lambda t: t), ("vector", lambda t: t[:, 0])):
        o["pallas_" + form] = (
            jpm.gram_matvec(kj, d["x_pl"], pick(d["v_pl"]), nugget=1e-3, bt=128,
                            interpret=True),
            jpm.cross_matvec(gpx.se(2.0, 3.0), d["x1_pl"], d["x_pl"],
                             pick(d["v_pl"]), bt=128, interpret=True))

    pc = jgi.pivoted_cholesky_preconditioner(kj.kernels[0], x, 30, 0.501)
    o["apply"], o["logdet"] = pc.apply(d["pv"]), pc.logdet
    o["sample"] = {b: pc.sample(PC_KEY, 6, base=b) for b in ("normal", "rademacher")}
    o["base"] = {"normal": jax.random.normal(PC_KEY, (N, 6), jnp.float64),
                 "rademacher": jax.random.rademacher(PC_KEY, (N, 6),
                                                     dtype=jnp.float64)}
    mv = lambda v: jpm.gram_matvec(kj, x, v, nugget=1e-3)
    o["slq_pc"] = jgi.slq_logdet_preconditioned(mv, pc, SLQ_KEY, n_probes=8, m=20)
    o["slq_pc_u"] = jax.random.normal(SLQ_KEY, (N, 8), jnp.float64)

    mv_cg = lambda v: d["m_cg"] @ v
    diag_cg = lambda v: v / jnp.diag(d["m_cg"])[:, None]
    o["cg"] = (jgi.cg_solve(mv_cg, d["b_cg"], tol=1e-9, precond=diag_cg),
               jgi.cg_solve(mv_cg, d["b_cg"][:, 0], tol=1e-9, max_iters=5))
    mv_l = lambda v: d["m_l"] @ v
    o["lanczos"] = jax.vmap(lambda z: jgi.lanczos(mv_l, z, 20), in_axes=1)(d["z_l"])
    o["slq"] = jgi.slq_logdet(mv_l, 60, SLQ_KEY, n_probes=8, m=20, dtype=jnp.float64)
    o["slq_z"] = _per_key_rademacher(SLQ_KEY, 60, 8)
    o["pcg"] = jgi._pcg_tridiag(lambda v: d["m_p"] @ v, d["z_p"], 25,
                                lambda v: v / jnp.diag(d["m_p"])[:, None])
    o["pcg_sticky"] = jgi._pcg_tridiag(
        lambda v: jnp.diag(jnp.asarray([-1.0, 2.0, 3.0])) @ v, d["z_s"], 6,
        lambda v: v)

    # the entry points, and the base noise they draw from KEY
    o["logml"] = {rank: jgi.logml_value_and_grad_iterative(
        jp, x, y, KEY, precond_rank=rank, **OPTS) for rank in (0, 30)}
    _, k_slq, k_probe = jax.random.split(KEY, 3)
    s = OPTS["n_probes"]
    o["probe_noise"] = jax.random.rademacher(k_probe, (N, s), dtype=jnp.float64)
    o["slq_noise"] = {
        30: jax.random.normal(k_slq, (N, s), jnp.float64),
        0: _per_key_rademacher(k_slq, N, s)}
    # variance="none" returns the mean of the "exact" run bit for bit
    # (the same operations before the variance branch)
    o["fit"] = {rank: jgi.fit_iterative(jp, x, y, d["xs"], cg_tol=1e-9,
                                        variance_block=32, precond_rank=rank)
                for rank in (0, 16)}
    return o


# The oracles run once, at small n: compile them for compile time, not
# speed. On one core, LLVM at -O0 without fusion emitters cuts XLA's
# compile of them from ~23 s to ~5 s and slows their run by ~1 s.
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}


@pytest.fixture(scope="module")
def ref():
    d = _data(np.random.default_rng(7))
    kj = gpx.se(3.0, 5.5) + gpx.white(0.5)
    jp = gpx.Parameters(mean=gpx.zero(), kernel=kj)
    oracles = jax.jit(partial(_oracles, kj), compiler_options=_FAST_COMPILE)
    o = jax.block_until_ready(oracles(jp, {k: jnp.asarray(v) for k, v in d.items()}))
    # eagerly, as gpx's own test runs it: under jit, XLA on the CPU rounds
    # the centred differences of the duplicates away from exactly 0 and
    # White drops out (1.39 off numpy at one row)
    o["cross"] = jpm.cross_matvec(kj, *(jnp.asarray(d[k]) for k in ("x1", "x2", "v2")))
    kt = gt.se(3.0, 5.5, **F64) + gt.white(0.5, **F64)
    tp = params_from_numpy(gt.Parameters(mean=gt.zero(), kernel=kt),
                           jax.tree_util.tree_leaves(jp))
    return d, o, kt, tp


@pytest.mark.parametrize("form", ["matrix", "vector"])
def test_matvec_plain_matches_gpx_xla(ref, form):
    """float64; row blocks of 64 (the last ragged) and of 2048 (one); the
    cross product has duplicates across its two sets (White fires)."""
    d, o, kt, _ = ref
    pick = (lambda t: t) if form == "matrix" else (lambda t: t[:, 0])
    x, x1, x2 = _t(d["x"]), _t(d["x1"]), _t(d["x2"])
    gram, cross = np.asarray(o["gram"]), np.asarray(o["cross"])
    for block in (64, 2048):
        got = _gram_matvec_torch(kt, x - x.mean(0), _t(d["v"]), 1e-3, block)
        np.testing.assert_allclose(pick(got.numpy()), pick(gram), rtol=1e-10)
        c = x2.mean(0)
        got = _cross_matvec_torch(kt, x1 - c, x2 - c, _t(d["v2"]), block)
        np.testing.assert_allclose(pick(got.numpy()), pick(cross), rtol=1e-10)
    got = tmv.gram_matvec(kt, x, pick(_t(d["v"])), nugget=1e-3)
    np.testing.assert_allclose(got.numpy(), pick(gram), rtol=1e-10)
    got = tmv.cross_matvec(kt, x1, x2, pick(_t(d["v2"])))
    np.testing.assert_allclose(got.numpy(), pick(cross), rtol=1e-10)


@pytest.mark.parametrize("form", ["matrix", "vector"])
def test_matvec_plain_matches_gpx_pallas(ref, form):
    """n = 256 in float32 against gpx's Pallas kernels in interpret mode
    (bt = 128); the tolerances of gpx's own interpret tests
    (test_iterative.py: 3e-4 for the Gram product, 2e-5 / 1e-4 cross)."""
    d, o, _, _ = ref
    pick = (lambda t: t) if form == "matrix" else (lambda t: t[:, 0])
    want_gram, want_cross = o["pallas_" + form]
    x, v = _t(d["x_pl"]), pick(_t(d["v_pl"]))
    got = tmv.gram_matvec(gt.se(3.0, 5.5, **F32) + gt.white(0.5, **F32), x, v,
                          nugget=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_gram), rtol=3e-4,
                               atol=3e-4)
    got = tmv.cross_matvec(gt.se(2.0, 3.0, **F32), _t(d["x1_pl"]), x, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_cross), rtol=2e-5,
                               atol=1e-4)


def test_gradient_contraction_matches_jax_grad(ref):
    """autograd through the checkpointed row blocks (64 rows: three blocks,
    the last ragged) against jax.grad through _gram_matvec_xla."""
    d, o, kt, _ = ref
    x, a, w, u = _t(d["x"]), _t(d["a"]), _t(d["w"]), _t(d["u"])
    kl = [t.detach().requires_grad_() for t in tparams.leaves(kt)]
    kern = tparams.unflatten(kt, kl)
    quad = 0.5 * (a @ _gram_matvec_torch(kern, x, a[:, None], 1e-3, 64)[:, 0])
    tr = torch.mean(torch.sum(u * _gram_matvec_torch(kern, x, w, 1e-3, 64), dim=0))
    got = [float(g) for g in torch.autograd.grad(quad - 0.5 * tr, kl)]
    want = [float(g) for g in jax.tree_util.tree_leaves(o["contraction"])]
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("case", ["diag_precond", "capped_vector"])
def test_cg_solve_matches_gpx(ref, case):
    """A (Jacobi-preconditioned) batch whose second column (1e-4 of the
    others' scale) converges and freezes first: the iteration count and the flag equal gpx's, and
    both solutions lie within ||m^-1|| tol = 1e-9 of the exact one (the
    eigenvalues of m are 1 ... 100), so they agree within 2e-9.
    "capped_vector": the (N,) form stopped by ``max_iters``, to
    round-off."""
    d, o, _, _ = ref
    m, b = _t(d["m_cg"]), _t(d["b_cg"])
    mv = lambda v: m @ v
    if case == "diag_precond":
        got = gi.cg_solve(mv, b, tol=1e-9, precond=lambda v: v / m.diagonal()[:, None])
        want = o["cg"][0]
    else:
        got, want = gi.cg_solve(mv, b[:, 0], tol=1e-9, max_iters=5), o["cg"][1]
    assert got[1] == int(want[1]) and got[2] is bool(want[2]) is (case != "capped_vector")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=2e-9 if case != "capped_vector" else 1e-12)


def test_lanczos_and_slq_match_gpx(ref):
    """The port's block Lanczos against gpx's per-vector Lanczos, column
    by column; plain SLQ on gpx's per-probe draws."""
    d, o, _, _ = ref
    m = _t(d["m_l"])
    got_a, got_b = gi.lanczos(lambda v: m @ v, _t(d["z_l"]), 20)
    want_a, want_b = (np.asarray(t).T for t in o["lanczos"])
    np.testing.assert_allclose(got_a.numpy(), want_a, rtol=1e-8)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=1e-8)
    one = gi.lanczos(lambda v: m @ v, _t(d["z_l"][:, 0]), 20)
    np.testing.assert_allclose(one[0].numpy(), want_a[:, 0], rtol=1e-8)
    got = gi._slq_logdet(lambda v: m @ v, _t(o["slq_z"]), 20)
    np.testing.assert_allclose(float(got), float(o["slq"]), rtol=1e-8)
    # the public function draws its own probes from a generator
    exact = np.linalg.slogdet(d["m_l"])[1]
    est = gi.slq_logdet(lambda v: m @ v, 60, torch.Generator().manual_seed(0),
                        n_probes=8, m=20, dtype=torch.float64)
    assert est.dtype == torch.float64 and abs(float(est) - exact) < 0.1 * abs(exact)


@pytest.mark.parametrize("case", ["preconditioned", "sticky"])
def test_pcg_tridiag_matches_gpx(ref, case):
    """"sticky": an indefinite system on which every column breaks down or
    converges within 3 steps; only the (1, 0) extension may follow
    (gpx's test_pcg_tridiag_freeze_is_sticky)."""
    d, o, _, _ = ref
    if case == "sticky":
        m, z, steps, pc = torch.diag(_t([-1.0, 2.0, 3.0])), _t(d["z_s"]), 6, None
        want = o["pcg_sticky"]
    else:
        m, z, steps = _t(d["m_p"]), _t(d["z_p"]), 25
        pc, want = (lambda v: v / m.diagonal()[:, None]), o["pcg"]
    got = gi._pcg_tridiag(lambda v: m @ v, z, steps, pc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-12)
    if case == "sticky":
        np.testing.assert_allclose(got[0][4:].numpy(), 1.0)
        np.testing.assert_allclose(got[1][4:].numpy(), 0.0)


def test_preconditioner_matches_gpx(ref):
    """apply, logdet and sample (on gpx's base draws), which do not depend
    on the signs of the basis (w may differ in them), then preconditioned
    SLQ on gpx's Normal draws; the pivoted Cholesky takes ``method`` as
    gpx does."""
    d, o, kt, _ = ref
    x = _t(d["x"])
    smooth = kt.kernels[0]
    pc = gi.pivoted_cholesky_preconditioner(smooth, x, 30, 0.501)
    want = np.asarray(o["apply"])
    np.testing.assert_allclose(pc.apply(_t(d["pv"])).numpy(), want, rtol=1e-8)
    np.testing.assert_allclose(pc.apply(_t(d["pv"][:, 0])).numpy(), want[:, 0],
                               rtol=1e-8)
    np.testing.assert_allclose(float(pc.logdet), float(o["logdet"]), rtol=1e-10)
    for base, z in o["sample"].items():
        np.testing.assert_allclose(pc.root(_t(o["base"][base])).numpy(),
                                   np.asarray(z), rtol=1e-8, atol=1e-12)
        drawn = pc.sample(torch.Generator().manual_seed(1), 6, base=base)
        assert drawn.shape == (N, 6) and drawn.dtype == torch.float64
    got = gi._slq_logdet_preconditioned(
        lambda v: tmv.gram_matvec(kt, x, v, nugget=1e-3), pc,
        pc.root(_t(o["slq_pc_u"])), 20)
    np.testing.assert_allclose(float(got), float(o["slq_pc"]), rtol=1e-8)
    assert torch.equal(gi.pivoted_cholesky(smooth, x, 8, method="auto"),
                       gi.pivoted_cholesky(smooth, x, 8))


@pytest.mark.parametrize("rank", [0, 30])
def test_logml_iterative_matches_gpx(ref, rank):
    """The private core on gpx's own noise against gpx's public function:
    value and every gradient to 1e-6 relative in float64 (round-off),
    CG iterations within one (the stop at cg_tol = 1e-8 may move by
    one)."""
    d, o, _, tp = ref
    got = gi._logml_value_and_grad_iterative(
        tp, _t(d["x"]), _t(d["y"]), probe_noise=_t(o["probe_noise"]),
        slq_noise=_t(o["slq_noise"][rank]), lanczos_iters=OPTS["lanczos_iters"],
        cg_tol=OPTS["cg_tol"], precond_rank=rank)
    want = o["logml"][rank]
    np.testing.assert_allclose(float(got.value), float(want.value), rtol=1e-6)
    np.testing.assert_allclose(
        [float(g) for g in tparams.leaves(got.grads)],
        [float(g) for g in jax.tree_util.tree_leaves(want.grads)], rtol=1e-6)
    assert abs(got.cg_iters - int(want.cg_iters)) <= 1
    assert got.cg_converged is bool(want.cg_converged) is True


@pytest.mark.parametrize("rank", [0, 16])
@pytest.mark.parametrize("variance", ["exact", "none"])
def test_fit_iterative_matches_gpx(ref, rank, variance):
    """Mean and variance to 1e-8 absolute in float64; ``"none"`` returns
    an empty variance and the same mean."""
    d, o, _, tp = ref
    got = gi.fit_iterative(tp, _t(d["x"]), _t(d["y"]), d["xs"], cg_tol=1e-9,
                           variance_block=32, precond_rank=rank, variance=variance)
    want = o["fit"][rank]
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=0,
                               atol=1e-8)
    if variance == "exact":
        np.testing.assert_allclose(got.variance.numpy(), np.asarray(want.variance),
                                   rtol=0, atol=1e-8)
    else:
        assert got.variance.shape == (0,)
    assert got.x.device.type == "cpu"
    assert got.cg_iters == int(want.cg_iters)
    assert got.cg_converged is bool(want.cg_converged) is True


def test_entry_points_public_and_scope(ref):
    """The public logML draws from a generator (on any device) and repeats
    with the same seed; a Plane mean gets its gradient; mesh= (a one-rank
    gloo mesh here) gives the same estimate and posterior; numpy input goes
    to the card, which raises without one."""
    d, _, kt, _ = ref
    x, y = _t(d["x"])[:60], _t(d["y"])[:60]
    tp = gt.Parameters(mean=gt.plane([0.1, -0.2], **F64), kernel=kt)

    def run(seed):
        return gi.logml_value_and_grad_iterative(
            tp, x, y, torch.Generator().manual_seed(seed), n_probes=4,
            lanczos_iters=10, precond_rank=8)

    a, b = run(3), run(3)
    assert float(a.value) == float(b.value) and np.isfinite(float(a.value))
    assert tparams.names(a.grads) == tparams.names(tp)
    assert all(torch.equal(g, h) for g, h in zip(tparams.leaves(a.grads),
                                                  tparams.leaves(b.grads)))
    with one_rank_mesh() as mesh:
        c = gi.logml_value_and_grad_iterative(
            tp, x, y, torch.Generator().manual_seed(3), n_probes=4,
            lanczos_iters=10, precond_rank=8, mesh=mesh)
        # solved to round-off, so that both stop at the same solution
        fits = [gi.fit_iterative(tp, x, y, x, cg_tol=1e-12, mesh=m)
                for m in (mesh, None)]
    for got, want in zip([c.value, *tparams.leaves(c.grads)],
                         [a.value, *tparams.leaves(a.grads)]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9)
    for got, want in zip(fits[0][1:3], fits[1][1:3]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                                   atol=1e-12)
    with pytest.raises(ValueError):
        gi.fit_iterative(tp, x, y, x, variance="diag")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            gi.fit_iterative(tp, d["x"], d["y"], d["xs"])


@pytest.mark.parametrize("name, want", [
    ("se_white", True), ("matern_half_integer", True),
    ("se_product", True), ("product_of_sum", True),
    ("past_the_limit", ValueError),
    ("product_of_sum_in_table", True),
    ("matern_general_nu", False), ("linear", False)])
def test_matvec_route_on_the_card(name, want):
    """The dispatch's gate for a float32 CUDA tensor (a stand-in: the gate
    reads only its device and type): the JAX package's Pallas gate; a
    Product of Sums that the CUDA term table holds takes the kernel (24
    factors, past the old 8-row table, too), and a Pallas-safe kernel that
    the table cannot take (a tree past its 256 factors) raises, naming its
    size, instead of running the plain route at every solver step."""
    kern = {"se_white": lambda: gt.se(1.0, 2.0, **F32) + gt.white(0.5, **F32),
            "matern_half_integer": lambda: gt.matern(1.0, 1.5, 2.0, **F32),
            "se_product": lambda: gt.se(1.0, 2.0, **F32) * gt.se(1.0, 3.0, **F32),
            "product_of_sum_in_table": lambda: gt.Product(
                (gt.se(1.0, 2.0, **F32) + gt.white(0.5, **F32),
                 gt.periodic(1.0, 3.0, 2.0, **F32))),
            "product_of_sum": lambda: gt.Product((
                gt.se(1.0, 2.0, **F32) + gt.matern(1.0, 1.5, 2.0, **F32),
                gt.periodic(1.0, 3.0, 2.0, **F32)
                + gt.rational_quadratic(1.0, 0.7, 2.0, **F32),
                gt.se(1.0, 3.0, **F32) + gt.white(0.5, **F32))),
            "past_the_limit": lambda: gt.Sum(
                [gt.se(1.0, 2.0, **F32) * gt.periodic(1.0, 3.0, 2.0, **F32)]
                * 129),
            "matern_general_nu": lambda: gt.matern(1.0, 1.3, 2.0, **F32),
            "linear": lambda: gt.linear(1.0, **F32)}[name]()
    on_card = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    assert not tmv._uses_cuda_kernel(kern, torch.zeros((2, 1)))
    assert not tmv._uses_cuda_kernel(
        kern, SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64))
    if want is ValueError:
        with pytest.raises(ValueError, match="has 258 factors"):
            tmv._uses_cuda_kernel(kern, on_card)
    else:
        assert tmv._uses_cuda_kernel(kern, on_card) is want
