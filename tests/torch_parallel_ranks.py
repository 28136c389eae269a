"""The rank side of ``tests/test_torch_parallel.py``: one program that every
rank of a 4-rank gloo world runs on the CPU, in float64, returning its
results as numpy. It imports torch and ``gpx_torch`` only, so that each
rank starts quickly; the test's parent process holds the results
against ``gpx``.

Ranks that are not in a smaller mesh (``data=1``, ``data=2``) skip its
cases; every rank runs the others in the same order, so that their
collectives pair.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

F64 = dict(device="cpu", dtype=torch.float64)
PANEL = 32


@contextlib.contextmanager
def one_rank_mesh():
    """A gloo world of this process alone and its one-rank ``data`` mesh
    for the ``with`` block (the world destroyed at its end): the other test
    files' check that each ``mesh=`` reaches the distributed path."""
    from gpx_torch.parallel import make_mesh
    from gpx_torch.parallel.mesh import world

    with world("cpu"):
        yield make_mesh(data=1, device="cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a), **F64)


def _np(t):
    return t.detach().cpu().numpy()


def _bench(gt, sigma=5.5):
    return gt.Parameters(mean=gt.zero(),
                         kernel=gt.se(3.0, sigma, **F64) + gt.white(0.5, **F64))


def _flat(gt, tree):
    return np.concatenate([_np(t).reshape(-1) for t in gt.params.leaves(tree)])


def _factor_cases(out, inp, mesh):
    from gpx_torch.parallel import comm, dist_chol

    k, b, bm = _t(inp["spd"]), _t(inp["b"]), _t(inp["bm"])
    l = dist_chol.distributed_cholesky(k, mesh, panel=PANEL)
    out["chol"] = _np(comm.all_gather(l.to_local(), mesh, "data"))
    # the factor's trailing updates write in place into a block of their
    # own, never into the caller's K
    out["k_kept"] = bool(torch.equal(k, _t(inp["spd"])))
    out["forward"] = _np(dist_chol.distributed_forward_solve(l, b, mesh,
                                                             panel=PANEL))
    out["back"] = _np(dist_chol.distributed_back_solve(l, b, mesh,
                                                       panel=PANEL))
    out["half_logdet"] = float(dist_chol.distributed_half_logdet(l, mesh))
    cols = dist_chol.distributed_forward_solve_cols(
        l, dist_chol.sharded(dist_chol.local(bm, mesh), mesh), mesh,
        panel=PANEL)
    out["cols"] = _np(comm.all_gather(cols.to_local(), mesh, "data"))


def _errors(out, inp, mesh):
    """The shapes that do not split raise ValueError, as the JAX package's
    do; so does a mesh larger than the world."""
    import gpx_torch as gt
    from gpx_torch.parallel import dist_chol, make_mesh
    from gpx_torch.parallel.dist_matvec import distributed_gram_matvec

    raised = []
    k = _t(inp["spd"])[:132, :132]            # 132 / 4 = 33 rows a rank
    for fn in (lambda: dist_chol.distributed_cholesky(k, mesh, panel=PANEL),
               lambda: dist_chol.distributed_forward_solve(
                   k, k[0], mesh, panel=PANEL),
               lambda: distributed_gram_matvec(    # 130 rows over 4 ranks
                   _bench(gt).kernel, k[:130, :1], mesh),
               lambda: make_mesh(data=8, device="cpu")):
        try:
            fn()
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["raised"] = np.array(raised)


def _logml_cases(out, inp, meshes):
    import gpx_torch as gt
    from gpx_torch.parallel import (distributed_logml,
                                    distributed_logml_value_and_grad)

    x, y = _t(inp["x"]), _t(inp["y"])
    for d, mesh in meshes.items():
        if mesh.get_coordinate() is None:
            continue
        v, g = distributed_logml_value_and_grad(_bench(gt), x, y, mesh,
                                                panel=PANEL)
        out[f"logml_d{d}"] = np.concatenate([[float(v)], _flat(gt, g)])
    # the value alone, no autograd record: the panel program as the
    # largest run takes it
    with torch.no_grad():
        out["logml_nograd"] = float(distributed_logml(
            _bench(gt), x, y, meshes[4], panel=PANEL))


def _predict_cases(out, inp, mesh, grid_mesh):
    import gpx_torch as gt
    from gpx_torch.parallel import (distributed_gram_matvec,
                                    distributed_predict, sharded_gram,
                                    sharded_logml, sharded_predict)

    x, y, xs = _t(inp["x"]), _t(inp["y"]), _t(inp["xs"])
    p = _bench(gt)
    post = distributed_predict(p, x, y, xs, mesh, panel=PANEL)
    out["dpredict"] = np.stack([_np(post.mean), _np(post.variance)])
    post = sharded_predict(p, x, y, xs, mesh)
    out["spredict"] = np.stack([_np(post.mean), _np(post.variance)])
    out["slogml"] = float(sharded_logml(p, x, y, mesh))
    k = sharded_gram(p.kernel, x, grid_mesh, nugget=1e-3,
                     axes=("chains", "data"))
    out["sgram"] = _np(k.full_tensor())
    from gpx_torch.parallel import comm

    for key, pts in (("dmatvec", x), ("dmatvec_pair", _t(inp["x_pair"]))):
        mv = distributed_gram_matvec(p.kernel, pts, mesh, nugget=1e-3)
        out[key] = _np(comm.all_gather(mv(_t(inp["v"])).to_local(), mesh,
                                       "data"))


def _against_one_device(out, inp, mesh):
    """Each ``mesh=`` path at d = 4 and the same call without a mesh."""
    import gpx_torch as gt
    from gpx_torch.models import gp_iterative as gi
    from gpx_torch.models import gridgp
    from gpx_torch.models import multioutput as mo
    from gpx_torch.models import multioutput_iterative as moi

    x, y, xs = _t(inp["x"]), _t(inp["y"]), _t(inp["xs"])
    p = _bench(gt)

    def gen():
        return torch.Generator().manual_seed(7)

    kw = dict(n_probes=4, lanczos_iters=8, cg_tol=1e-9, precond_rank=8)
    for tag, m in (("mesh", mesh), ("one", None)):
        r = gi.logml_value_and_grad_iterative(p, x, y, gen(), mesh=m, **kw)
        out[f"it_logml_{tag}"] = np.concatenate([[float(r.value)],
                                                 _flat(gt, r.grads)])
        f = gi.fit_iterative(p, x, y, xs[:16], cg_tol=1e-9,
                             variance_block=16, precond_rank=8, mesh=m)
        out[f"it_fit_{tag}"] = np.stack([_np(f.mean), _np(f.variance)])

    icm = mo.icm(gt.se(1.0, 2.0, **F64), n_outputs=2, rank=1, kappa=0.2,
                 noise=0.3)
    ym = _t(inp["ym"])
    for tag, m in (("mesh", mesh), ("one", None)):
        r = moi.logml_value_and_grad_iterative(
            icm, x[:64], ym, gen(), n_probes=4, lanczos_iters=8,
            cg_tol=1e-9, mesh=m)
        out[f"icm_{tag}"] = np.concatenate([[float(r.value)],
                                            _flat(gt, r.grads)])

    grid = gridgp.grid([gt.se(1.0, 1.0, **F64), gt.se(1.0, 2.0, **F64)],
                       noise=0.1)
    axes = [_t(inp["ax0"]), _t(inp["ax1"])]
    gy = _t(inp["gy"])
    for tag, m in (("mesh", mesh), ("one", None)):
        v = gridgp.log_marginal_likelihood(grid, axes, gy, mesh=m)
        f = gridgp.fit(grid, axes, gy, _t(inp["gxs"]), mesh=m)
        out[f"grid_{tag}"] = np.concatenate([[float(v)], _np(f.mean),
                                             _np(f.variance)])


def _optimize_and_samplers(out, inp, mesh):
    import gpx_torch as gt
    from gpx_torch.distributions import Gamma
    from gpx_torch.infer import sample_hmc, sample_mh
    from gpx_torch.models.optimize import optimize

    # one panel a rank: the fewest collectives an evaluation can make
    x, y = _t(inp["x"])[:128], _t(inp["y"])[:128]

    def log_prior(p):
        g = Gamma(torch.tensor(2.0, **F64), torch.tensor(2.0, **F64))
        return sum(g.logpdf(t) for t in gt.params.leaves(p.kernel))

    for tag, m in (("mesh", mesh), ("one", None)):
        r = optimize(_bench(gt, sigma=2.0), x, y, steps=4, mesh=m,
                     panel=PANEL, log_prior=log_prior)
        out[f"opt_{tag}"] = _flat(gt, r.params)
        post = sample_hmc(3, x, y, _bench(gt), log_prior, 3, l=2, eps=0.05,
                          n_chains=1, init_jitter=0.05, mesh=m, panel=PANEL)
        out[f"hmc_{tag}"] = _np(post.flat)
        post = sample_mh(4, x, y, _bench(gt), log_prior, 3, n_chains=2,
                         proposal_scale=0.1, mesh=m, panel=PANEL)
        out[f"mh_{tag}"] = _np(post.flat)


def _chains_cases(out, inp, grid_mesh, chains_mesh):
    import gpx_torch as gt
    from gpx_torch.distributions import Gamma
    from gpx_torch.infer import base, mh, sample_mh
    from gpx_torch.models import gp
    from gpx_torch.parallel import sample_chains_sharded, sample_mh_2d

    x, y = _t(inp["x"])[:128], _t(inp["y"])[:128]

    def log_prior(p):
        g = Gamma(torch.tensor(2.0, **F64), torch.tensor(2.0, **F64))
        return sum(g.logpdf(t) for t in gt.params.leaves(p.kernel))

    logpost, flat0, _ = mh.make_unconstrained_log_posterior(
        lambda p: log_prior(p) + gp.log_marginal_likelihood(p, x, y),
        _bench(gt))
    step = mh.kernel(logpost, mh.gaussian_random_walk(0.1))
    init = mh.init(flat0, logpost)
    sharded = sample_chains_sharded(step, init, 5, 3, 4, chains_mesh,
                                    collect=lambda s: s.position)
    one = base.sample_chains(step, init, 5, 3, 4,
                             collect=lambda s: s.position)
    out["chains_sharded"] = np.stack([_np(sharded.samples),
                                      _np(one.samples)])
    kw = dict(proposal_scale=0.1, n_chains=4)
    post = sample_mh_2d(6, x, y, _bench(gt), log_prior, 3, grid_mesh,
                        panel=PANEL, **kw)
    one = sample_mh(6, x, y, _bench(gt), log_prior, 3, **kw)
    out["mh_2d"] = np.stack([_np(post.flat), _np(one.flat)])


def _svgp_case(out, inp, mesh):
    """``svgp.train(mesh=)`` against one device on the union of the ranks'
    minibatches: each rank's draw is patched to its rows of one global
    batch."""
    import gpx_torch as gt
    from gpx_torch.models import svgp
    from gpx_torch.parallel import comm

    x, y, z = _t(inp["x"])[:64], _t(inp["y"])[:64], _t(inp["x"])[64:72]
    batches = inp["batches"]                     # (steps, 16) global rows
    n_loc = 16
    my = comm.axis_index(mesh, "data")
    p = _bench(gt)
    keep = svgp._batch_indices
    try:
        step = iter(range(batches.shape[0]))
        mine = [b[(b >= my * n_loc) & (b < (my + 1) * n_loc)] - my * n_loc
                for b in batches]
        svgp._batch_indices = lambda gen, n, b, device: torch.as_tensor(
            mine[next(step)], device=device)
        dist = svgp.train(0, p, z, x, y, noise=0.25, batch_size=16,
                          steps=batches.shape[0], learning_rate=0.05,
                          mesh=mesh)
        step = iter(range(batches.shape[0]))
        svgp._batch_indices = lambda gen, n, b, device: torch.as_tensor(
            batches[next(step)], device=device)
        one = svgp.train(0, p, z, x, y, noise=0.25, batch_size=16,
                         steps=batches.shape[0], learning_rate=0.05)
    finally:
        svgp._batch_indices = keep
    out["svgp"] = np.stack([
        np.concatenate([_flat(gt, r[0]), _np(r[1]).reshape(-1),
                        _np(r[4])]) for r in (dist, one)])


def run(rank, inp):
    """Every case of the test file on this rank; returns ``{name: numpy}``."""
    from gpx_torch.parallel import make_mesh
    from gpx_torch.parallel.dryrun import _dryrun_rank

    meshes = {d: make_mesh(data=d, device="cpu") for d in (1, 2, 4)}
    grid_mesh = make_mesh(chains=2, data=2, device="cpu")
    chains_mesh = make_mesh(chains=4, device="cpu")
    m4 = meshes[4]
    out = {}
    _factor_cases(out, inp, m4)
    _errors(out, inp, m4)
    _logml_cases(out, inp, meshes)
    _predict_cases(out, inp, m4, grid_mesh)
    _against_one_device(out, inp, m4)
    _optimize_and_samplers(out, inp, m4)
    _chains_cases(out, inp, grid_mesh, chains_mesh)
    _svgp_case(out, inp, m4)
    _dryrun_rank(rank, 4, "cpu")
    out["dryrun"] = True
    return out
