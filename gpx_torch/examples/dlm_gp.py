"""Joint DLM-GP fit — examples/src/main/scala/FitDlmGp.scala /
TemperatureDlm.scala:181-253 (TemperatureDlmGp).

Simulates the joint spatio-temporal model (latent DLM state shared across
sensors + GP spatial residuals), then runs the joint Gibbs sampler: FFBS
state draw with ``v = Kxx``, kernel-MH on residuals, conjugate W draw.
"""

import pathlib

import numpy as np
import torch

import gpx_torch as gt
from gpx_torch._device import resolve_device
from gpx_torch import plots
from gpx_torch.distributions import Gamma, InverseGamma
from gpx_torch.examples import _common
from gpx_torch.examples.temperature import uniform_locations
from gpx_torch.models import dlm, dlmgp

OUT = pathlib.Path(__file__).parent / "output"
N_SENSORS = 8


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("n_iters", nargs="?", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=200,
                    help="time steps of the simulated record")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    OUT.mkdir(exist_ok=True)

    key = _common.generator(device, args.seed)
    locs = uniform_locations(key, N_SENSORS, [0.0, 0.0], [5.0, 5.0])
    model = dlm.replicate_observations(dlm.polynomial(1, device=device),
                                       N_SENSORS)
    truth = gt.Parameters(
        mean=gt.zero(),
        kernel=gt.se(1.0, 2.0, device=device) + gt.white(0.2, device=device),
    )
    states, ys = dlmgp.simulate(
        key, model, truth, locs, v_extra=torch.tensor(0.01, device=device),
        w=torch.tensor([0.05], device=device),
        m0=torch.zeros(1, device=device), n_steps=args.steps,
    )

    pr = Gamma(concentration=torch.tensor(2.0, device=device),
               rate=torch.tensor(2.0, device=device))

    def log_prior_kernel(kern):
        c0, c1 = kern.kernels
        return pr.logpdf(c0.h) + pr.logpdf(c0.sigma) + pr.logpdf(c1.sigma)

    template = gt.Parameters(
        mean=gt.zero(),
        kernel=gt.se(0.5, 1.0, device=device) + gt.white(0.5, device=device),
    )
    prior_w = InverseGamma(concentration=torch.tensor(3.0, device=device),
                           scale=torch.tensor(0.1, device=device))
    result = dlmgp.gibbs_sample(
        key, model, ys, locs, template, log_prior_kernel, prior_w,
        m0=torch.zeros(1, device=device),
        c0=torch.eye(1, device=device) * 10.0, n_iters=args.n_iters,
        proposal_scale=0.1,
    )

    keep = args.n_iters // 2
    kmed = torch.median(result.kernel_flat[keep:], dim=0).values
    wmed = torch.median(result.w[keep:, 0])
    print("kernel posterior medians (truth 1.0, 2.0, 0.2): "
          f"{np.round(kmed.cpu().numpy(), 3)}")
    print(f"W posterior median (truth 0.05): {float(wmed):.4f}")
    print(f"kernel-MH accept rate: {float(result.accept_rate):.2f}")

    if not args.no_plots:
        fig = plots.traceplot(result.kernel_flat[:, 0])
        plots.savefig(fig, OUT / "dlmgp_trace_h.png")
        # state recovery
        fig, ax = plots._plt().subplots(figsize=(10, 4))
        ax.plot(states[:, 0].cpu().numpy(), label="true state", lw=1)
        ax.plot(result.states[keep:, :, 0].mean(0).cpu().numpy(),
                label="posterior mean", lw=1)
        ax.legend()
        plots.savefig(fig, OUT / "dlmgp_state.png")
        print(f"wrote {OUT}/dlmgp_state.png")
    return {"locs": locs, "states": states, "ys": ys, "result": result,
            "kernel_medians": kmed, "w_median": wmed}


if __name__ == "__main__":
    main()
