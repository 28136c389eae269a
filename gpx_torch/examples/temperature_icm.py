"""Coupled-sensor temperatures with a multi-output (ICM) GP.

The reference models its 8 temperature sensors with one SHARED latent DLM
(TemperatureDlm.scala:83-118; rebuilt in temperature_dlm.py). The ICM is
the GP answer to the same data: each sensor is an output, coupled through
B = W Wᵀ + diag(κ) over a common temporal SE kernel — it learns
per-sensor loadings (including anti-correlated sensors, which a
shared-trend DLM cannot express) and forecasts every sensor jointly.

Workflow: simulate 4 days of hourly temperatures at 8 coupled sensors →
type-II MLE of all ICM hyperparameters (`multioutput.optimize`, L-BFGS on
the Kronecker-diagonalized logML) → 24 h joint forecast for every sensor
→ short MH run for the posterior over the coupling.
"""

import pathlib

import numpy as np
import torch

import gpx_torch as gt
from gpx_torch._device import resolve_device
from gpx_torch import diagnostics, plots
from gpx_torch.distributions import Gamma, Normal
from gpx_torch.examples import _common
from gpx_torch.models import multioutput as mo

OUT = pathlib.Path(__file__).parent / "output"
N_SENSORS = 8


def synthetic_sensors(key, n_hours=96):
    """Hourly temps at 8 sensors: one latent daily cycle, per-sensor
    loadings (sensor 7 anti-correlated — an urban/valley site)."""
    dev = key.device
    hours = torch.arange(n_hours, dtype=torch.float32, device=dev)[:, None]
    w = torch.tensor(
        [[1.0], [0.9], [1.1], [0.8], [0.95], [1.05], [0.7], [-0.6]],
        device=dev)
    truth = mo.IcmParams(
        kernel=gt.se(4.0, 10.0, device=dev),   # ~10 h temporal correlation
        w=w,
        kappa=torch.full((N_SENSORS,), 0.1, device=dev),
        noise=torch.tensor(0.2, device=dev),
    )
    temps = 12.0 + mo.draw(key, truth, hours)
    return hours, temps, truth


def log_prior_fn(device):
    g = Gamma(concentration=torch.tensor(2.0, device=device),
              rate=torch.tensor(1.0, device=device))
    nw = Normal(loc=torch.tensor(0.0, device=device),
                scale=torch.tensor(2.0, device=device))

    def log_prior(p):
        return (g.logpdf(p.kernel.h) + g.logpdf(p.kernel.sigma)
                + torch.sum(nw.logpdf(p.w)) + torch.sum(g.logpdf(p.kappa))
                + g.logpdf(p.noise))

    return log_prior


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("n_iters", nargs="?", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=80,
                    help="L-BFGS steps of the type-II MLE")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    OUT.mkdir(exist_ok=True)

    x, temps, truth = synthetic_sensors(_common.generator(device, args.seed))
    y = temps - temps.mean(dim=0)      # zero-mean per output

    # --- type-II MLE over kernel + coupling + noise -----------------------
    template = mo.icm(gt.se(2.0, 6.0, device=device), n_outputs=N_SENSORS,
                      rank=1, kappa=0.3, noise=0.5)
    res = mo.optimize(template, x, y, steps=args.steps)
    b_hat = mo.coregion_matrix(res.params).detach().cpu().numpy()
    print(f"logML {float(res.values[0]):.1f} -> {float(res.value):.1f} "
          f"(grad norm {float(res.grad_norm):.2e})")
    print("fitted coupling row 0:", np.round(b_hat[0], 2))
    print(f"fitted noise: {float(res.params.noise):.3f} (truth 0.2)")

    # --- joint 24 h forecast for every sensor -----------------------------
    xs = torch.arange(x.shape[0], x.shape[0] + 24, dtype=torch.float32,
                      device=device)[:, None]
    fc = mo.fit(res.params, x, y, xs)
    lo, hi = fc.interval(0.05), fc.interval(0.95)
    off = temps.mean(dim=0)
    print("24 h forecast, first hour, all sensors:")
    for i in range(N_SENSORS):
        print(f"  sensor {i}: {float(fc.mean[0, i] + off[i]):6.2f} "
              f"[{float(lo[0, i] + off[i]):6.2f}, "
              f"{float(hi[0, i] + off[i]):6.2f}]")

    # --- posterior over the coupling (short MH) ---------------------------
    post = mo.sample_mh(
        _common.generator(device, args.seed + 1), x, y, res.params,
        log_prior_fn(device), n_samples=args.n_iters,
        burn_in=args.n_iters // 5, n_chains=2, proposal_scale=0.05,
    )
    print(diagnostics.format_summary(diagnostics.summary(post.flat,
                                                         post.names)))
    # sensor 7's loading must come out negative (times sensor 0's sign)
    w = post.flat[..., [post.names.index(f"w_{i}") for i in range(N_SENSORS)]]
    signs = torch.sign(torch.median(w.reshape(-1, N_SENSORS), dim=0).values)
    print("posterior coupling signs (up to joint flip):",
          (signs * signs[0]).cpu().numpy())

    if not args.no_plots:
        plt = plots._plt()
        fig, axes = plt.subplots(4, 2, figsize=(10, 10), sharex=True)
        h, hs = x[:, 0].cpu().numpy(), xs[:, 0].cpu().numpy()
        for i, ax in enumerate(axes.ravel()):
            o = float(off[i])
            ax.plot(h, temps[:, i].cpu().numpy(), "k.", ms=2)
            ax.plot(hs, fc.mean[:, i].cpu().numpy() + o)
            ax.fill_between(hs, lo[:, i].cpu().numpy() + o,
                            hi[:, i].cpu().numpy() + o, alpha=0.3)
            ax.set_title(f"sensor {i}")
        fig.tight_layout()
        fig.savefig(OUT / "temperature-icm.png", dpi=100)
        plt.close(fig)
        print(f"wrote {OUT / 'temperature-icm.png'}")
    return {"x": x, "y": y, "xs": xs, "params": res.params,
            "values": res.values, "value": res.value,
            "grad_norm": res.grad_norm, "forecast_mean": fc.mean,
            "forecast_variance": fc.variance, "flat": post.flat,
            "names": post.names, "accept_rate": post.accept_rate,
            "signs": signs * signs[0]}


if __name__ == "__main__":
    main()
