"""gpx_torch.parallel against gpx.parallel and the single-device paths:
four gloo ranks on the CPU, float64.

One module fixture starts the four ranks once (``run_ranks``: forked from a
fresh fork server, one torch thread each, a file store in a temporary
directory); every port-side
case runs in them (``tests/torch_parallel_ranks.py``) and comes back as
numpy. The parent joins with a time limit and kills the ranks when it runs
out, so a hung collective fails these tests instead of stalling the
suite. The gpx oracles run here, in the parent: one ``shard_map`` program
(``distributed_cholesky``, forward only) and single-device gpx calls; no
gpx distributed gradient is compiled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpx import Parameters, se, white, zero
from gpx.models import gp
from gpx.ops.pallas_matvec import gram_matvec
from gpx.parallel import (distributed_cholesky, distributed_gram_matvec,
                          make_mesh)

from tests import torch_parallel_ranks as ranks

N, M, PANEL, STEPS = 256, 64, 32, 4
# the rows of x_pair that repeat another's point: (first, second)
PAIRS = np.array([[0, 1], [100, 200]])
# each gpx oracle one jitted program, compiled for compile time
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True,
                 "xla_cpu_use_fusion_emitters": False}
# the ranks share what cores there are; the fork server's imports take a
# few seconds on one core, and every case a fraction of one
TIMEOUT_S = 240


def _inputs():
    rng = np.random.default_rng(0)
    spectrum = np.concatenate([[1.0, 100.0], rng.uniform(1.0, 100.0, N - 2)])
    q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    # four global batches of 16 rows, four from each rank's 16-row shard
    batches = np.stack([np.concatenate([r * 16 + rng.choice(16, 4, False)
                                        for r in range(4)])
                        for _ in range(STEPS)])
    b, bm = rng.normal(size=N), rng.normal(size=(N, 48))
    x = rng.uniform(-5.0, 5.0, size=(N, 1))
    x_pair = x.copy()
    x_pair[PAIRS[:, 1]] = x_pair[PAIRS[:, 0]]
    return {
        "spd": (q * spectrum) @ q.T,
        "b": b, "bm": bm, "x": x, "x_pair": x_pair, "y": rng.normal(size=N),
        "xs": np.linspace(-5.0, 5.0, M)[:, None],
        "v": rng.normal(size=(N, 3)), "ym": rng.normal(size=(64, 2)),
        "ax0": rng.uniform(-3.0, 3.0, size=(8, 1)),
        "ax1": rng.uniform(-1.0, 1.0, size=(5, 1)),
        "gy": rng.normal(size=(8, 5)),
        "gxs": rng.uniform(-1.0, 1.0, size=(6, 2)),
        "batches": batches,
    }


@pytest.fixture(scope="module")
def run():
    from gpx_torch.parallel.dryrun import run_ranks

    inp = _inputs()
    outs = run_ranks(ranks.run, 4, backend="gloo", args=(inp,),
                     timeout_s=TIMEOUT_S, threads=1)
    return inp, outs


def _bench():
    return Parameters(mean=zero(), kernel=se(3.0, 5.5) + white(0.5))


def _oracle(fn, *args):
    return jax.jit(fn).lower(*args).compile(_FAST_COMPILE)(*args)


def _leaves(tree):
    return np.concatenate([np.ravel(np.asarray(t))
                           for t in jax.tree_util.tree_leaves(tree)])


def test_replicated_results_agree_across_ranks(run):
    """Every rank gets the same replicated result."""
    _, outs = run
    for key in ("logml_d4", "forward", "back", "dpredict", "spredict",
                "it_logml_mesh", "grid_mesh", "opt_mesh", "hmc_mesh",
                "chains_sharded", "mh_2d", "svgp"):
        for other in outs[1:]:
            np.testing.assert_array_equal(other[key], outs[0][key])


def test_distributed_cholesky_matches_gpx(run):
    inp, outs = run
    mesh = make_mesh(data=4)
    want = _oracle(lambda k: distributed_cholesky(k, mesh, panel=PANEL),
                   jnp.asarray(inp["spd"]))
    np.testing.assert_allclose(outs[0]["chol"], np.asarray(want), atol=1e-8)


@pytest.mark.parametrize("what", ["forward", "back", "cols", "half_logdet"])
def test_solves_and_logdet(run, what):
    """At the JAX package's own tolerances (tests/test_dist_chol.py)."""
    inp, outs = run
    l = np.linalg.cholesky(inp["spd"])
    if what == "half_logdet":
        np.testing.assert_allclose(outs[0][what],
                                   np.sum(np.log(np.diag(l))), rtol=1e-10)
        return
    want = {"forward": lambda: np.linalg.solve(l, inp["b"]),
            "back": lambda: np.linalg.solve(l.T, inp["b"]),
            "cols": lambda: np.linalg.solve(l, inp["bm"])}[what]()
    np.testing.assert_allclose(outs[0][what], want, atol=1e-8)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_distributed_logml_value_and_grad_matches_gpx(run, d):
    """A gradient rule of the wrong kind is off by a factor of d."""
    inp, outs = run
    v, g = _oracle(lambda p, x, y: gp.logml_value_and_grad(
        p, x, y, method="autodiff"), _bench(), jnp.asarray(inp["x"]),
        jnp.asarray(inp["y"]))
    got = outs[0][f"logml_d{d}"]
    np.testing.assert_allclose(got[0], float(v), rtol=1e-9)
    np.testing.assert_allclose(got[1:], _leaves(g), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("which", ["dpredict", "spredict"])
def test_predict_matches_gpx_fit(run, which):
    inp, outs = run
    post = _oracle(gp.fit, _bench(), jnp.asarray(inp["x"]),
                   jnp.asarray(inp["y"]), jnp.asarray(inp["xs"]))
    np.testing.assert_allclose(outs[0][which][0], np.asarray(post.mean),
                               atol=1e-8)
    np.testing.assert_allclose(outs[0][which][1], np.asarray(post.variance),
                               atol=1e-8)


def test_sharded_logml_matches_gpx(run):
    inp, outs = run
    want = _oracle(gp.log_marginal_likelihood, _bench(),
                   jnp.asarray(inp["x"]), jnp.asarray(inp["y"]))
    np.testing.assert_allclose(outs[0]["slogml"], float(want), rtol=1e-10)


def test_sharded_gram_matches_gpx(run):
    inp, outs = run
    want = _oracle(lambda x: _bench().kernel.gram(x, nugget=1e-3),
                   jnp.asarray(inp["x"]))
    np.testing.assert_allclose(outs[0]["sgram"], np.asarray(want),
                               rtol=1e-12, atol=1e-12)


def test_distributed_gram_matvec_matches_gpx(run):
    """gpx's matvec runs eagerly, as its own tests run it on the CPU."""
    inp, outs = run
    want = gram_matvec(_bench().kernel, jnp.asarray(inp["x"]),
                       jnp.asarray(inp["v"]), nugget=1e-3)
    np.testing.assert_allclose(outs[0]["dmatvec"], np.asarray(want),
                               rtol=1e-10, atol=1e-10)


def test_distributed_gram_matvec_at_coincident_points_is_gpxs(run):
    """Where two points coincide, the mesh matvec puts White on the
    diagonal only (``split_noise``), and the single-device ``gram_matvec``
    also at the pair's r2 = 0. The port's mesh matvec is gpx's own
    ``distributed_gram_matvec`` (eager, on 4 of the 8 virtual devices),
    and both differ from gpx's single-device product on the pairs' rows
    alone."""
    inp, outs = run
    kernel, x = _bench().kernel, jnp.asarray(inp["x_pair"])
    v = jnp.asarray(inp["v"])
    want = np.asarray(distributed_gram_matvec(kernel, x, make_mesh(data=4),
                                              nugget=1e-3)(v))
    np.testing.assert_allclose(outs[0]["dmatvec_pair"], want, rtol=1e-10,
                               atol=1e-10)
    one = np.asarray(gram_matvec(kernel, x, v, nugget=1e-3))
    differs = np.flatnonzero(np.abs(want - one).max(axis=1) > 1e-8)
    np.testing.assert_array_equal(differs, np.sort(PAIRS.ravel()))


@pytest.mark.parametrize("case", ["it_logml", "it_fit", "icm", "grid", "opt",
                                  "hmc", "mh", "svgp"])
def test_mesh_matches_one_device(run, case):
    """Each ``mesh=`` path at d = 4 against the same call without a mesh,
    on the same probes, keys and minibatches: the iterative logML and
    fit_iterative, the matrix-free ICM, the grid logML and fit, optimize
    (L-BFGS, the same optimum), sample_hmc and sample_mh (the same chain)
    and svgp.train (the same trajectory)."""
    _, outs = run
    if case == "svgp":
        got, want = outs[0]["svgp"]
    else:
        got, want = outs[0][f"{case}_mesh"], outs[0][f"{case}_one"]
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-9)


def test_sample_chains_sharded_is_sample_chains(run):
    _, outs = run
    sharded, one = outs[0]["chains_sharded"]
    assert sharded.shape == (4, 3, 3)
    np.testing.assert_array_equal(sharded, one)


def test_sample_mh_2d_is_sample_mh(run):
    """The 2-D mesh's batched chains take sample_mh's draws."""
    _, outs = run
    two_d, one = outs[0]["mh_2d"]
    assert two_d.shape == (4, 3, 3)
    np.testing.assert_allclose(two_d, one, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("i,what", enumerate(
    ["cholesky 33 rows a rank", "forward solve 33 rows a rank",
     "matvec 130 rows over 4", "mesh of 8 in a world of 4"]))
def test_shapes_that_do_not_split_raise(run, i, what):
    _, outs = run
    assert outs[0]["raised"][i], what


def test_dryrun_multichip_sequence(run):
    """dryrun_multichip's rank program (HMC on the (chains, data) mesh,
    distributed logML and predict, sharded chains, the matrix-free ICM and
    the grid with mesh=, sample_mh_2d) ran on every rank."""
    _, outs = run
    assert all(o["dryrun"] for o in outs)
