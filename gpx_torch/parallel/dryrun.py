"""Spawning ranks on one host, and the multi-device dry run — the port of
``__graft_entry__.dryrun_multichip``.

:func:`run_ranks` starts ``world_size`` processes, joins them to one
process group through a file store in a fresh temporary directory (no
network port), runs a function in each and returns each rank's result. The
ranks are forked from a ``forkserver``: a fresh interpreter, not a fork of
the caller, that has imported torch and the DTensor layer once, so the
ranks start as clean as spawned ones without importing them each; it is
stopped when the ranks have ended. A rank
that raises, dies or outlives the time limit ends the whole run with a
``RuntimeError``: the others are killed, nothing waits for ever.

:func:`dryrun_multichip` runs, on ``n_devices`` ranks, the sequence of the
JAX package's dry run: an HMC step on a ``(chains, data)`` mesh whose
likelihood is the distributed panel Cholesky, the distributed logML and
gradient and ``distributed_predict``, ``sample_chains_sharded``, the
matrix-free multi-output logML with ``mesh=``, the grid logML with
``mesh=`` and ``sample_mh_2d``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from multiprocessing import forkserver

import numpy as np
import torch
import torch.distributed as dist

from gpx_torch.parallel.mesh import TIMEOUT_S, init_process_group

# what every rank imports, loaded once in the fork server (DTensor's
# constructor imports torch._dynamo at its first call); none of it touches
# the card, so the forked ranks initialise CUDA themselves
_PRELOAD = ["torch", "torch.distributed.tensor", "torch._dynamo",
            "gpx_torch.parallel"]


def _rank_main(rank, world_size, store_dir, backend, threads, fn,
               results):
    try:
        with open(os.path.join(store_dir, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        if threads:
            torch.set_num_threads(threads)
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        init_process_group(rank, world_size, store_dir, backend=backend)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, *, backend: str, args=(),
              timeout_s: float = 600.0, threads: int | None = None) -> list:
    """``[fn(rank, *args) for rank in range(world_size)]``, each call in its
    own process joined to a ``backend`` process group (``"gloo"``:
    CPU ranks, or ranks that share a card; ``"nccl"``: one card a rank).
    With a card, rank ``r`` works on card ``r % device_count``. ``fn`` must
    be importable by name and its results picklable. ``threads`` sets each
    rank's torch CPU threads."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="gpx_torch_ranks_")
    # the arguments go through a file: a rank that dies before reading a
    # large argument from its start pipe would leave the write blocked
    with open(os.path.join(store_dir, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, store_dir, backend, threads,
                               fn, results))
             for r in range(world_size)]
    outs, errors = {}, []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(outs) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"timed out after {timeout_s:.0f} s with ranks "
                              f"{sorted(set(range(world_size)) - set(outs))} "
                              f"unfinished")
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    # a rank died without reporting (killed): give the
                    # others the process group's timeout to report, no more
                    deadline = min(deadline, time.monotonic() + TIMEOUT_S)
                continue
            if ok:
                outs[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            if errors:
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
        # and the fork server, waited for: nothing this started outlives it
        # (the standard library's own way to stop it, as its tests do)
        forkserver._forkserver._stop()
    if errors:
        raise RuntimeError("ranks failed: " + "\n".join(errors))
    return [outs[r] for r in range(world_size)]


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = 600.0) -> None:
    """The multi-device dry run on ``n_devices`` ranks of their own, on the card
    (ranks that outnumber the cards share them over gloo, else NCCL) or on
    the CPU (``device="cpu"``, gloo). Raises if any part fails."""
    on_card = torch.device(device).type == "cuda"
    backend = ("nccl" if on_card and torch.cuda.device_count() >= n_devices
               else "gloo")
    run_ranks(_dryrun_rank, n_devices, backend=backend,
              args=(n_devices, str(device)), timeout_s=timeout_s,
              threads=None if on_card else 1)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _dryrun_rank(rank, n_devices, device):
    import gpx_torch as gt
    from gpx_torch.distributions import Gamma
    from gpx_torch._device import generators
    from gpx_torch.infer import hmc, mh
    from gpx_torch.models import gp, gridgp
    from gpx_torch.models import multioutput as mo
    from gpx_torch.models.multioutput_iterative import (
        logml_value_and_grad_iterative)
    from gpx_torch.parallel import (
        distributed_logml, distributed_logml_value_and_grad,
        distributed_predict, make_mesh, sample_chains_sharded, sample_mh_2d)
    from gpx_torch.parallel import comm

    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh(chains=2, data=n_devices // 2, device=device)
    else:
        mesh = make_mesh(chains=1, data=n_devices, device=device)
    chains_mesh = make_mesh(chains=n_devices, device=device)
    d_data = comm.axis_size(mesh, "data")
    rows = comm.axis_size(mesh, "chains")
    n_chains = 2 * rows
    n = 8 * d_data
    f32 = dict(device=device, dtype=torch.float32)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-10.0, 10.0, size=(n, 1)), **f32)
    y = torch.as_tensor(rng.normal(size=n), **f32)
    template = gt.Parameters(mean=gt.zero(),
                             kernel=gt.se(3.0, 5.5, **f32)
                             + gt.white(0.5, **f32))

    def log_prior(p):
        pr = Gamma(torch.tensor(2.0, **f32), torch.tensor(0.5, **f32))
        k0, k1 = p.kernel.kernels
        return pr.logpdf(k0.h) + pr.logpdf(k0.sigma) + pr.logpdf(k1.sigma)

    # an HMC step of each chain of this rank's mesh row, every likelihood
    # the panel Cholesky over the row's data ranks
    def log_density(p):
        return log_prior(p) + distributed_logml(p, x, y, mesh, panel=8)

    logpost, flat0, _ = mh.make_unconstrained_log_posterior(log_density,
                                                            template)
    vag = hmc.value_and_grad(logpost)
    gens = generators(0, n_chains, x.device)
    c0 = comm.axis_index(mesh, "chains") * 2
    positions = torch.stack([
        hmc._step(gens[c], hmc.init(flat0, logpost), vag, 0.05, 3,
                  None)[0].position for c in range(c0, c0 + 2)])
    positions = comm.all_gather(positions, mesh, "chains")
    _check(positions.shape == (n_chains, flat0.numel())
           and bool(torch.isfinite(positions).all()), "the HMC step")

    # the distributed logML, its gradient and prediction at N >= 1024
    n_dist = max(256 * d_data, 1024)
    n_dist += (-n_dist) % (128 * d_data)
    x_d = torch.as_tensor(rng.uniform(-10.0, 10.0, size=(n_dist, 1)), **f32)
    y_d = torch.as_tensor(rng.normal(size=n_dist), **f32)
    val, grads = distributed_logml_value_and_grad(template, x_d, y_d, mesh,
                                                  panel=128)
    _check(bool(torch.isfinite(val)) and all(
        bool(torch.isfinite(g).all()) for g in gt.params.leaves(grads)),
        "the distributed logML and gradient")
    xs_d = torch.linspace(-10.0, 10.0, 2 * d_data, **f32)[:, None]
    summary = distributed_predict(template, x_d, y_d, xs_d, mesh, panel=128)
    _check(bool(torch.isfinite(summary.mean).all())
           and bool((summary.variance >= 0).all()), "distributed_predict")

    # chains split over the whole mesh
    def log_density_local(p):
        return log_prior(p) + gp.log_marginal_likelihood(p, x, y)

    logpost_local, _, _ = mh.make_unconstrained_log_posterior(
        log_density_local, template)
    step = mh.kernel(logpost_local, mh.gaussian_random_walk(0.1))
    result = sample_chains_sharded(step, mh.init(flat0, logpost_local), 3, 3,
                                   n_devices, chains_mesh,
                                   collect=lambda s: s.position)
    _check(result.samples.shape[:2] == (n_devices, 3)
           and bool(torch.isfinite(result.samples).all()),
           "sample_chains_sharded")

    # the matrix-free multi-output logML, every matvec row-sharded
    icm = mo.icm(gt.se(1.0, 1.0, **f32), n_outputs=2, rank=1, kappa=0.1,
                 noise=0.1)
    y_mo = torch.as_tensor(rng.normal(size=(n, 2)), **f32)
    est = logml_value_and_grad_iterative(
        icm, x, y_mo, torch.Generator(device=x.device).manual_seed(5),
        n_probes=4, lanczos_iters=8, cg_tol=1e-4, cg_max_iters=200,
        mesh=mesh)
    _check(bool(torch.isfinite(est.value)) and all(
        bool(torch.isfinite(g).all()) for g in gt.params.leaves(est.grads)),
        "the matrix-free multi-output logML")

    # the grid logML, the lattice's leading axis sharded
    grid = gridgp.grid([gt.se(1.0, 1.0, **f32), gt.se(1.0, 2.0, **f32)],
                       noise=0.1)
    axes = [torch.as_tensor(rng.uniform(-3, 3, size=(4 * d_data, 1)), **f32),
            torch.as_tensor(rng.uniform(-1, 1, size=(5, 1)), **f32)]
    gy = torch.as_tensor(rng.normal(size=(4 * d_data, 5)), **f32)
    gval = gridgp.log_marginal_likelihood(grid, axes, gy, mesh=mesh)
    _check(bool(torch.isfinite(gval)), "the grid logML")

    # MH on the 2-D (chains, data) mesh
    if rows > 1:
        post = sample_mh_2d(4, x_d, y_d, template, log_prior, 3, mesh,
                            proposal_scale=0.1, panel=128)
        _check(post.flat.shape[0] == rows
               and bool(torch.isfinite(post.flat).all()), "sample_mh_2d")
    return rank
