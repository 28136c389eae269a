"""Spatial temperature GP — examples/src/main/scala/Temperature.scala.

2-D sensor locations, Plane mean + SE + white kernel, MH-within-Gibbs over
(plane mean | kernel hyperparameters), then prediction at a held-out sensor
with posterior-mean parameters (Temperature.scala:64-180). The reference
reads a sensor CSV that isn't shipped with its repo; this example generates a
synthetic sensor network from the same model family (or reads
``--data <csv>`` with columns lon,lat,temp if you have one).
"""

import pathlib

import torch

import gpx_torch as gt
from gpx_torch._device import resolve_device
from gpx_torch import diagnostics, io
from gpx_torch.distributions import Gamma, Normal
from gpx_torch.examples import _common
from gpx_torch.infer import sample_mh_within_gibbs
from gpx_torch.models import gp

OUT = pathlib.Path(__file__).parent / "output"


def uniform_locations(key, n, lo, hi):
    """``n`` points uniform on the box ``[lo, hi]`` (two corners), from the
    generator ``key``."""
    lo, hi = (torch.tensor(v, device=key.device) for v in (lo, hi))
    u = torch.rand((n, lo.shape[0]), generator=key, device=key.device)
    return lo + (hi - lo) * u


def synthetic_sensors(key, n_sensors=25):
    locs = uniform_locations(key, n_sensors, [-1.8, 54.8], [-1.2, 55.2])
    dev = key.device
    truth = gt.Parameters(
        mean=gt.plane([12.0, 2.0, 0.0], device=dev),
        kernel=gt.se(1.5, 0.3, device=dev) + gt.white(0.2, device=dev),
    )
    temps = gp.draw(key, truth, locs)
    return locs, temps


def log_prior_kernel_fn(device):
    pr = Gamma(concentration=torch.tensor(2.0, device=device),
               rate=torch.tensor(2.0, device=device))

    def log_prior_kernel(kern):
        k0, k1 = kern.kernels
        return pr.logpdf(k0.h) + pr.logpdf(k0.sigma) + pr.logpdf(k1.sigma)

    return log_prior_kernel


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("n_iters", nargs="?", type=int, default=1000)
    ap.add_argument("--data", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    OUT.mkdir(exist_ok=True)

    if args.data:
        flat, _ = io.read_chain_csv(args.data)
        flat = torch.as_tensor(flat, dtype=torch.get_default_dtype(),
                               device=device)
        locs, temps = flat[:, :2], flat[:, 2]
    else:
        locs, temps = synthetic_sensors(_common.generator(device, args.seed))

    # hold out the last sensor for prediction (Temperature.scala:127-180)
    x_train, y_train = locs[:-1], temps[:-1]
    x_test = locs[-1:]

    template = gt.Parameters(
        mean=gt.plane(torch.zeros(3, device=device)),
        kernel=gt.se(1.0, 1.0, device=device) + gt.white(0.5, device=device),
    )
    post = sample_mh_within_gibbs(
        _common.generator(device, args.seed + 1), x_train, y_train, template,
        log_prior_kernel_fn(device),
        Normal(loc=torch.tensor(0.0, device=device),
               scale=torch.tensor(10.0, device=device)),
        n_samples=args.n_iters, burn_in=args.n_iters // 5, n_chains=2,
        proposal_scale=0.1,
    )
    io.write_chains_csv(OUT / "temperature-mcmc.csv", post.flat, post.names)
    print(diagnostics.format_summary(diagnostics.summary(post.flat,
                                                         post.names)))

    # posterior-mean parameters -> prediction at the held-out sensor
    p_hat = gt.params.from_array(template, post.flat.mean((0, 1)))
    summary = gp.fit(p_hat, x_train, y_train, x_test)
    print(
        f"held-out sensor: observed {float(temps[-1]):.2f}, "
        f"predicted {float(summary.mean[0]):.2f} "
        f"± {1.64 * float(torch.sqrt(summary.variance[0])):.2f} (90%)"
    )
    return {"flat": post.flat, "names": post.names,
            "accept_rate": post.accept_rate, "observed": temps[-1],
            "mean": summary.mean, "variance": summary.variance}


if __name__ == "__main__":
    main()
