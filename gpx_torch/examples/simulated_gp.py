"""Simulated-GP example suite — examples/src/main/scala/SimulatedGp.scala.

Subcommands mirror the reference's App objects:
  simulate              SimulateGp (:39-45): draw + scatter plot
  replicate             SimulateGpReplicate (:48-60): repeated draws
  fit                   FitGp (:62-98): posterior fit on every-15th point
  parameters <nIters>   ParametersSimulatedGp (:100-166): MH, 4 chains
  hmc <nIters>          HmcSimulated (:168-195): eHMC sampling
  posterior-predictive  PosteriorPredictive (:197-247): spaghetti plot

Outputs land in gpx_torch/examples/output/ (plots as PNG, chains as CSV).
"""

import pathlib

import torch

import gpx_torch as gt
from gpx_torch._device import resolve_device
from gpx_torch import diagnostics, io, plots
from gpx_torch.distributions import Gamma
from gpx_torch.examples import _common
from gpx_torch.infer import sample_ehmc, sample_mh
from gpx_torch.models import gp

OUT = pathlib.Path(__file__).parent / "output"


def truth(device):
    """The docs model: se(h=3.0, sigma=5.5) + white(0.5)
    (docs/src/main/tut/docs/parameter_inference.md:18-27)."""
    return gt.Parameters(mean=gt.zero(), kernel=gt.se(3.0, 5.5, device=device)
                         + gt.white(0.5, device=device))


def template(device):
    return gt.Parameters(mean=gt.zero(), kernel=gt.se(1.0, 1.0, device=device)
                         + gt.white(1.0, device=device))


def simulate(key, n=300):
    """``n`` sorted design points on [-10, 10] and a draw of the truth
    there, both from the generator ``key``."""
    x = gp.sample_points(key, -10.0, 10.0, n)
    y = gp.draw(key, truth(key.device), x)
    return x, y


def log_prior_fn(device):
    """Gamma(2, 2) priors on every hyperparameter, as in the docs
    (parameter_inference.md:48-58)."""
    pr = Gamma(concentration=torch.tensor(2.0, device=device),
               rate=torch.tensor(2.0, device=device))

    def log_prior(p):
        k0, k1 = p.kernel.kernels
        return pr.logpdf(k0.h) + pr.logpdf(k0.sigma) + pr.logpdf(k1.sigma)

    return log_prior


def _observed(args, device):
    x, y = simulate(_common.generator(device, args.seed), n=args.n)
    return x, y, x[::15], y[::15]  # every-15th-point subsample (FitGp)


def cmd_simulate(args, device):
    x, y = simulate(_common.generator(device, args.seed), n=args.n)
    if not args.no_plots:
        plots.savefig(plots.scatter_plot(x, y), OUT / "simulated_gp.png")
        print(f"wrote {OUT}/simulated_gp.png")
    io.write_chain_csv(OUT / "simulated_gp.csv", torch.stack([x, y], -1),
                       ["x", "y"])
    return {"x": x, "y": y}


def cmd_replicate(args, device):
    key = _common.generator(device, args.seed)
    x = gp.sample_points(key, -10.0, 10.0, 100)
    draws = gp.draw(key, truth(device), x, shape=(10,))
    if not args.no_plots:
        plots.savefig(plots.pp_plot(x, draws),
                      OUT / "simulated_replicates.png")
        print(f"wrote {OUT}/simulated_replicates.png")
    return {"x": x, "draws": draws}


def cmd_fit(args, device):
    x, y, xobs, yobs = _observed(args, device)
    xs = torch.arange(-10.0, 10.0, 0.01, device=device)
    summary = gp.fit(truth(device), xobs, yobs, xs)
    if not args.no_plots:
        plots.savefig(plots.gp_plot(summary, obs=(xobs, yobs)),
                      OUT / "fitted_gp.png")
        print(f"wrote {OUT}/fitted_gp.png")
    return {"xobs": xobs, "yobs": yobs, "xs": xs, "mean": summary.mean,
            "variance": summary.variance}


def cmd_parameters(args, device):
    _, _, xobs, yobs = _observed(args, device)
    post = sample_mh(
        _common.generator(device, args.seed + 1), xobs, yobs,
        template(device), log_prior_fn(device), n_samples=args.n_iters,
        burn_in=args.n_iters // 10, n_chains=4, proposal_scale=0.12,
    )
    paths = io.write_chains_csv(OUT / "gpmcmc.csv", post.flat, post.names)
    if not args.no_plots:
        plots.savefig(plots.diagnostic_plots(post.flat, post.names),
                      OUT / "gpmcmc_diagnostics.png")
    print(diagnostics.format_summary(diagnostics.summary(post.flat,
                                                         post.names)))
    print("accept:", post.accept_rate.cpu().numpy())
    return {"flat": post.flat, "names": post.names,
            "accept_rate": post.accept_rate, "paths": paths}


def cmd_hmc(args, device):
    _, _, xobs, yobs = _observed(args, device)
    post = sample_ehmc(
        _common.generator(device, args.seed + 2), xobs, yobs,
        template(device), log_prior_fn(device), n_samples=args.n_iters,
        warmup_iters=args.warmup, k=args.k, l_max=128, n_chains=2,
    )
    paths = io.write_chains_csv(OUT / "gp_ehmc.csv", post.flat, post.names)
    print(diagnostics.format_summary(diagnostics.summary(post.flat,
                                                         post.names)))
    print("accept:", post.accept_rate.cpu().numpy())
    return {"flat": post.flat, "names": post.names,
            "accept_rate": post.accept_rate, "paths": paths}


def cmd_posterior_predictive(args, device):
    # resume from the MH chains the way the reference re-reads gpmcmc_0.csv
    # (SimulatedGp.scala:209-219)
    chain_path = OUT / "gpmcmc_0.csv"
    if not chain_path.exists():
        raise SystemExit("run `parameters` first (needs gpmcmc_0.csv)")
    flat, names = io.read_chain_csv(chain_path, burn_in=0,
                                    thin=max(1, args.n_iters // 20))
    # SAME seed and --n as the `parameters` stage: the resumed chains were
    # inferred from this dataset, so re-simulating it must reproduce it
    # exactly (pass the same flags to both invocations)
    _, _, xobs, yobs = _observed(args, device)
    xs = torch.arange(-10.0, 10.0, 0.05, device=device)
    curves = gp.posterior_predictive_curves(flat, template(device), xobs,
                                            yobs, xs, n_curves=20)
    if not args.no_plots:
        plots.savefig(plots.pp_plot(xs, curves),
                      OUT / "posterior_predictive.png")
        print(f"wrote {OUT}/posterior_predictive.png")
    return {"flat": flat, "names": names, "xs": xs, "curves": curves}


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("command", choices=[
        "simulate", "replicate", "fit", "parameters", "hmc",
        "posterior-predictive",
    ])
    ap.add_argument("n_iters", nargs="?", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--n", type=int, default=300,
        help="simulated dataset size (the reference fixes 300, "
        "SimulatedGp.scala:43)",
    )
    ap.add_argument("--warmup", type=int, default=200,
                    help="hmc: eHMC step-size warmup iterations")
    ap.add_argument("--k", type=int, default=200,
                    help="hmc: size of eHMC's empirical U-turn-length "
                    "distribution")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    OUT.mkdir(exist_ok=True)
    return {
        "simulate": cmd_simulate,
        "replicate": cmd_replicate,
        "fit": cmd_fit,
        "parameters": cmd_parameters,
        "hmc": cmd_hmc,
        "posterior-predictive": cmd_posterior_predictive,
    }[args.command](args, device)


if __name__ == "__main__":
    main()
