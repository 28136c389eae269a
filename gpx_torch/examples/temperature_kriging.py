"""Kriging on a spatial grid — examples/src/main/scala/TemperatureKriging.scala.

The reference's full workflow (TemperatureKriging.scala:37-107): the GP
residual-kernel hyperparameters are *inferred by MCMC*, the chain streams to
CSV, the posterior-mean parameters are re-read from that CSV (:37-50 reads
``temperature_gp_residuals_0.csv``), and the grid is krigged with them
(:84-107). The JAX package splits the grid's columns over a device mesh;
the port runs on one card, and ``gp.fit`` krigs the whole grid there.
"""

import pathlib

import torch

import gpx_torch as gt
from gpx_torch._device import resolve_device
from gpx_torch import io, plots
from gpx_torch.distributions import Gamma
from gpx_torch.examples import _common
from gpx_torch.examples.temperature import uniform_locations
from gpx_torch.infer import sample_mh
from gpx_torch.models import dlmgp, gp

OUT = pathlib.Path(__file__).parent / "output"


def log_prior_fn(device):
    pr = Gamma(concentration=torch.tensor(2.0, device=device),
               rate=torch.tensor(2.0, device=device))

    def log_prior(p):
        k0, k1 = p.kernel.kernels
        return pr.logpdf(k0.h) + pr.logpdf(k0.sigma) + pr.logpdf(k1.sigma)

    return log_prior


def fitted_params(post_mean, device, dtype=None):
    """The posterior-mean parameters read back from the chain CSV."""
    kw = dict(device=device, dtype=dtype)
    return gt.Parameters(
        mean=gt.zero(),
        kernel=gt.se(post_mean["kernel.kernels0.h"],
                     post_mean["kernel.kernels0.sigma"], **kw)
        + gt.white(post_mean["kernel.kernels1.sigma"], **kw),
    )


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("n_iters", nargs="?", type=int, default=1500)
    ap.add_argument("--nx", type=int, default=40)
    ap.add_argument("--ny", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    OUT.mkdir(exist_ok=True)

    key = _common.generator(device, args.seed)
    locs = uniform_locations(key, 30, [-1.8, 54.8], [-1.2, 55.2])
    truth = gt.Parameters(
        mean=gt.zero(),
        kernel=gt.se(1.0, 0.25, device=device) + gt.white(0.1, device=device),
    )
    resid = gp.draw(key, truth, locs)

    # 1. infer the residual-kernel hyperparameters by MH (the reference's
    #    chain is produced upstream by TemperatureDlm; here the MH fit runs
    #    in-example) and stream the chains to CSV
    template = gt.Parameters(
        mean=gt.zero(),
        kernel=gt.se(0.5, 0.5, device=device) + gt.white(0.3, device=device),
    )
    post = sample_mh(
        key, locs, resid, template, log_prior_fn(device),
        n_samples=args.n_iters, burn_in=0, n_chains=2, proposal_scale=0.15,
    )
    chain_base = OUT / "temperature_gp_residuals"
    paths = io.write_chains_csv(chain_base, post.flat, post.names)
    print(f"wrote chains: {[str(p) for p in paths]}")

    # 2. posterior-mean parameters re-read from the chain CSV with burn-in
    #    and thinning at read time (TemperatureKriging.scala:37-50 /
    #    Temperature.scala:137-141)
    draws, names = io.read_chain_csv(paths[0], burn_in=args.n_iters // 3,
                                     thin=2)
    post_mean = {n: float(v) for n, v in zip(names, draws.mean(axis=0))}
    print("posterior means from CSV:",
          {k: round(v, 3) for k, v in post_mean.items()})
    fitted = fitted_params(post_mean, device)

    # 3. krig the grid with the posterior-mean parameters
    grid = dlmgp.grid_locations((-1.8, -1.2), (54.8, 55.2), args.nx, args.ny,
                                device=device)
    summary = gp.fit(fitted, locs, resid, grid)
    print(f"krigged {args.nx * args.ny} grid cells on {device}")

    if not args.no_plots:
        plt = plots._plt()
        mean = summary.mean.reshape(args.nx, args.ny).cpu().numpy()
        sd = summary.variance.sqrt().reshape(args.nx, args.ny).cpu().numpy()
        xy = locs.cpu().numpy()
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        for ax, img, title in [(axes[0], mean, "posterior mean"),
                               (axes[1], sd, "posterior sd")]:
            im = ax.imshow(img.T, origin="lower",
                           extent=[-1.8, -1.2, 54.8, 55.2], aspect="auto")
            ax.scatter(xy[:, 0], xy[:, 1], c="red", s=10)
            ax.set_title(title)
            fig.colorbar(im, ax=ax)
        plots.savefig(fig, OUT / "kriging.png")
        print(f"wrote {OUT}/kriging.png ({args.nx}x{args.ny} grid)")
    return {"locs": locs, "resid": resid, "flat": post.flat,
            "names": post.names, "accept_rate": post.accept_rate,
            "post_mean": post_mean, "grid": grid, "mean": summary.mean,
            "variance": summary.variance}


if __name__ == "__main__":
    main()
