"""Sharded GP operations — the port of ``gpx/parallel/sharded.py``: the
block-sharded Gram, the logML with its Gram build sharded, prediction with
the test points sharded, chains sharded over a mesh axis, and MH on a 2-D
``(chains, data)`` mesh.

The JAX package states its sharding as ``PartitionSpec`` annotations and
lets XLA place the collectives; here every rank computes its block and the
collectives of :mod:`gpx_torch.parallel.comm` are written out. Results the
JAX package returns as global arrays come back replicated: the same tensor
on every rank.
"""

from __future__ import annotations

import torch

from gpx_torch import params as gparams
from gpx_torch._device import full_fp32, generators
from gpx_torch._module import FieldModule
from gpx_torch.models import gp
from gpx_torch.ops.chol import cholesky, forward_solve
from gpx_torch.ops.distance import as_locations
from gpx_torch.params import Parameters
from gpx_torch.parallel import comm
from gpx_torch.parallel.dist_chol import _HALF_LOG_2PI, local, logml_body


def _span(mesh, axis, n: int):
    """``(start, stop)`` of this rank's block of ``n`` items on
    ``mesh[axis]`` (all of them for ``axis=None``)."""
    if axis is None:
        return 0, n
    d = comm.axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"{n} rows must divide over the {d}-rank '{axis}' "
                         f"axis")
    i = comm.axis_index(mesh, axis)
    return i * (n // d), (i + 1) * (n // d)


def sharded_gram(kernel, x, mesh, *, nugget: float = 0.0, axes=("i", "j")):
    """The symmetric Gram (plus ``nugget`` on its diagonal) as a ``DTensor``
    2-D block-sharded over ``axes`` of ``mesh`` (``None`` keeps that
    dimension whole): each rank builds its block K(x_rows, x_cols) with the
    Gram kernel, so K never lives whole on one rank. The block's
    coordinates are centred on the whole set's mean, as the whole Gram's
    are, so White fires where it does there: on the global diagonal and at
    the points that centring makes coincide."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = as_locations(x)
    n = x.shape[0]
    r0, r1 = _span(mesh, axes[0], n)
    c0, c1 = _span(mesh, axes[1], n)
    block = kernel.gram(x[r0:r1], x[c0:c1], center_of=x)
    if nugget and c0 < r1 and r0 < c1:
        off = r0 - c0          # the global diagonal's column offset here
        block = block.diagonal_scatter(
            block.diagonal(off, dim1=-2, dim2=-1) + nugget, off, dim1=-2,
            dim2=-1)
    placements = [Shard(0) if name == axes[0] else
                  Shard(1) if name == axes[1] else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(block, mesh, placements, run_check=False)


def sharded_logml(params: Parameters, x, y, mesh, *,
                  nugget: float = gp.LOGML_NUGGET, data_axis: str = "data"):
    """logML with the Gram build sharded over the data axis: each rank
    builds its rows, which are all-gathered for a Cholesky that every rank
    runs whole, as XLA gathers K for its factor in the JAX package (the
    distributed factor is :func:`gpx_torch.parallel.distributed_logml`).
    Replicated."""
    full_fp32()
    x = as_locations(x)
    n = x.shape[0]
    k = comm.all_gather(local(sharded_gram(params.kernel, x, mesh,
                                           nugget=nugget,
                                           axes=(data_axis, None))),
                        mesh, data_axis)
    l = cholesky(k)
    u = forward_solve(l, y - params.mean(x))
    return (-0.5 * (u @ u) - torch.sum(torch.log(torch.diagonal(l)))
            - n * _HALF_LOG_2PI)


def sharded_predict(params: Parameters, x, y, xs, mesh, *,
                    nugget: float = gp.PREDICT_NUGGET, axis: str = "data"):
    """GPML Alg. 2.1 with the test points sharded over ``mesh[axis]``: the
    factor L and ``v = L^-1 (y - m)`` are computed whole on every rank (the
    JAX package broadcasts them), each rank builds its (N, M/d) cross block
    with the Gram kernel, solves it and forms its slice of the mean and
    variance, and the slices are all-gathered. Replicated."""
    full_fp32()
    x = as_locations(x)
    xs = as_locations(xs)
    m = xs.shape[0]
    d = comm.axis_size(mesh, axis)
    if m % d:
        raise ValueError(f"test points ({m}) must divide over mesh axis "
                         f"({d})")
    l = cholesky(params.kernel.gram(x, nugget=nugget))
    v = forward_solve(l, y - params.mean(x))
    s0, s1 = _span(mesh, axis, m)
    xs_blk = xs[s0:s1]
    a = forward_solve(l, params.kernel.gram(x, xs_blk))
    mean = params.mean(xs_blk) + a.T @ v
    var = torch.clamp_min(params.kernel.diag(xs_blk, dtype=mean.dtype)
                          - torch.sum(a * a, dim=0), 0.0)
    both = comm.all_gather(torch.stack([mean, var], dim=1), mesh, axis)
    return gp.PosteriorSummary(x=xs, mean=both[:, 0], variance=both[:, 1])


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, FieldModule):
        return gparams.unflatten(tree, [fn(t) for t in gparams.leaves(tree)])
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    fields = [_tree_map(fn, f) for f in tree]
    return type(tree)(*fields) if hasattr(tree, "_fields") else type(tree)(
        fields)


def sample_chains_sharded(step, init_state, key, n_samples: int,
                          n_chains: int, mesh, *, chains_axis: str = "chains",
                          burn_in: int = 0, thin: int = 1,
                          collect=lambda s: s):
    """``n_chains`` chains from ``init_state`` split over
    ``mesh[chains_axis]``: each rank runs its block of chains back to back
    and the results are all-gathered (the reference's two JVM threads at
    mesh scale). Chain ``c`` draws from the generator
    :func:`gpx_torch.infer.base.sample_chains` gives chain ``c`` of the
    same ``key``. Replicated ``ChainResult`` with leaves ``(n_chains,
    ...)``."""
    from gpx_torch.infer import base

    d = comm.axis_size(mesh, chains_axis)
    if n_chains % d:
        raise ValueError(f"n_chains ({n_chains}) must divide {d} shards")
    c0, c1 = _span(mesh, chains_axis, n_chains)
    gens = generators(key, n_chains, base._tensors(init_state)[0].device)
    runs = [base.sample(step, init_state, gens[c], n_samples,
                        burn_in=burn_in, thin=thin, collect=collect)
            for c in range(c0, c1)]
    return _tree_map(lambda t: comm.all_gather(t, mesh, chains_axis),
                     base.stack(runs))


def sample_mh_2d(key, x, y, template: Parameters, log_prior, n_samples: int,
                 mesh, *, chains_axis: str = "chains", data_axis: str = "data",
                 proposal_scale: float = 0.15, burn_in: int = 0, thin: int = 1,
                 nugget: float = gp.LOGML_NUGGET, init_jitter: float = 0.1,
                 panel: int = 128, n_chains: int | None = None):
    """MH over the hyperparameters on a 2-D ``(chains, data)`` mesh: the
    chains split over ``chains_axis`` while every logML of every chain
    runs the distributed panel Cholesky over ``data_axis``, so no rank
    holds the whole Gram. ``n_chains`` (default: one per mesh row) is a
    multiple of the chains axis; a row's chains go through the panel
    program as one batch. The inits and each chain's draws (its proposal,
    then its uniform) are :func:`gpx_torch.infer.mcmc.sample_mh`'s for the
    same ``key``. Returns the same ``PosteriorSamples``; replicated."""
    from gpx_torch.infer import mh
    from gpx_torch.infer.mcmc import _inits, _package

    full_fp32()
    x = as_locations(x)
    n = x.shape[0]
    rows = comm.axis_size(mesh, chains_axis)
    n_chains = rows if n_chains is None else n_chains
    if n_chains % rows:
        raise ValueError(f"n_chains ({n_chains}) must be a multiple of the "
                         f"chains axis ({rows})")
    d_data = comm.axis_size(mesh, data_axis)
    if n % d_data or (n // d_data) % panel:
        raise ValueError(f"N={n} must split into {d_data} row shards of "
                         f"panel-multiple size (panel={panel})")

    bij_tree = template.bijectors()
    _, flat0, unravel = mh.make_unconstrained_log_posterior(
        lambda c: torch.zeros(()), template, bij_tree)
    inits, k_run = _inits(key, flat0, n_chains, init_jitter)
    c0, c1 = _span(mesh, chains_axis, n_chains)
    gens = generators(k_run, n_chains, flat0.device)[c0:c1]
    x_loc = local(x, mesh, data_axis)

    def log_posterior(flats):                  # (k, dim) -> (k,)
        us = [unravel(f) for f in flats]
        cs = [gparams.constrain(bij_tree, u) for u in us]
        ll = logml_body(cs, x_loc, y, mesh=mesh, axis=data_axis, n=n,
                        nugget=nugget, panel=panel)
        return ll + torch.stack([log_prior(c)
                                 + gparams.log_det_jacobian(bij_tree, u)
                                 for c, u in zip(cs, us)])

    with torch.no_grad():
        q = inits[c0:c1]
        lp = log_posterior(q)
        accepted = torch.zeros(c1 - c0, dtype=torch.int32, device=q.device)
        draws = []
        steps = burn_in + n_samples * thin
        for i in range(steps):
            prop = torch.stack([
                qc + proposal_scale * torch.randn(qc.shape, generator=g,
                                                  dtype=qc.dtype,
                                                  device=qc.device)
                for qc, g in zip(q, gens)])
            lp_prop = log_posterior(prop)
            lp_prop = torch.where(torch.isnan(lp_prop), float("-inf"), lp_prop)
            u = torch.stack([torch.rand((), generator=g, dtype=lp.dtype,
                                        device=lp.device) for g in gens])
            accept = torch.log(u) < lp_prop - lp
            q = torch.where(accept[:, None], prop, q)
            lp = torch.where(accept, lp_prop, lp)
            accepted = accepted + accept.to(torch.int32)
            if i >= burn_in and (i - burn_in + 1) % thin == 0:
                draws.append(q)
        samples = comm.all_gather(torch.stack(draws, dim=1), mesh, chains_axis)
        accept_rate = comm.all_gather(accepted / steps, mesh, chains_axis)
    return _package(template, bij_tree, samples, accept_rate, {})
