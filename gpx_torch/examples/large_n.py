"""Large-N workflows — beyond the reference's few-thousand-point ceiling.

The reference builds the Gram entry-by-entry on the JVM and factors it with
one LAPACK call (GaussianProcess.scala:50-61,123), capping practical N at a
few thousand. This example drives the three scaling paths of the port end
to end:

  dense <n>        exact logML + gradient + dense-grid prediction through
                   the fused route (the Gram kernel, chol_inv, the
                   gradient kernel; the bench path)
  iterative <n>    matrix-free: preconditioned CG + mBCG SLQ logML, and
                   fit_iterative prediction (K never materializes)
  svgp <n>         minibatched SVGP training + predictive plot

Outputs land in gpx_torch/examples/output/. On the CPU the default sizes
stay quick; on the card they exercise the real scale.
"""

import pathlib
import time

import numpy as np
import torch

import gpx_torch as gt
from gpx_torch._device import resolve_device
from gpx_torch.examples import _common
from gpx_torch.models import gp

OUT = pathlib.Path(__file__).parent / "output"


def _data(n, key=0, noise=0.7, device=None):
    rng = np.random.default_rng(key)
    x = np.sort(rng.uniform(-10, 10, size=(n, 1)), axis=0).astype(np.float32)
    y = (np.sin(x[:, 0]) + rng.normal(size=n) * noise).astype(np.float32)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device))


def _params(device):
    return gt.Parameters(mean=gt.zero(), kernel=gt.se(2.0, 3.0, device=device)
                         + gt.white(0.5, device=device))


def _grid(device):
    return torch.linspace(-10, 10, 1024, device=device).reshape(-1, 1)


def run_dense(n, device, plots=True):
    x, y = _data(n, device=device)
    params = _params(device)
    t0 = time.time()
    val, grads = gp.logml_value_and_grad(params, x, y)
    print(f"dense logML+grad N={n}: {time.time() - t0:.1f}s (incl. kernel "
          f"load); value={float(val):.1f}")
    xs = _grid(device)
    summary = gp.fit(params, x, y, xs)
    if plots:
        _plot(xs, summary.mean, summary.variance, x, y,
              f"large_n_dense_{n}.png")
    return {"x": x, "y": y, "params": params, "value": val, "grads": grads,
            "xs": xs, "mean": summary.mean, "variance": summary.variance}


def run_iterative(n, device, plots=True):
    from gpx_torch.models.gp_iterative import (
        fit_iterative,
        logml_value_and_grad_iterative,
    )

    x, y = _data(n, device=device)
    params = _params(device)
    t0 = time.time()
    res = logml_value_and_grad_iterative(
        params, x, y, _common.generator(device, 0), n_probes=8,
        lanczos_iters=32, cg_tol=1e-4, precond_rank=64,
    )
    print(f"iterative logML+grad N={n}: {time.time() - t0:.1f}s; "
          f"value={float(res.value):.1f} "
          f"(CG {int(res.cg_iters)} iters, converged {bool(res.cg_converged)})")
    xs = _grid(device)
    post = fit_iterative(
        params, x, y, xs, cg_tol=1e-4, precond_rank=64,
        variance="exact", variance_block=256,
    )
    if plots:
        _plot(xs, post.mean, post.variance, x, y,
              f"large_n_iterative_{n}.png")
    return {"x": x, "y": y, "params": params, "value": res.value,
            "grads": res.grads, "cg_iters": res.cg_iters,
            "cg_converged": res.cg_converged, "xs": xs, "mean": post.mean,
            "variance": post.variance}


def run_svgp(n, device, plots=True, steps=300):
    from gpx_torch.models import sparse, svgp

    x, y = _data(n, device=device)
    z0 = sparse.init_inducing(_common.generator(device, 1), x, 64)
    t0 = time.time()
    p2, z2, state, noise2, trace = svgp.train(
        _common.generator(device, 2), _params(device), z0, x, y,
        noise=0.5, batch_size=min(512, n), steps=steps, train_noise=True,
    )
    tr = trace.detach().cpu().numpy()
    print(f"svgp N={n}: {time.time() - t0:.1f}s; "
          f"ELBO {tr[:5].mean():.0f} -> {tr[-5:].mean():.0f}, "
          f"noise {float(noise2):.3f}")
    xs = _grid(device)
    pred = svgp.fit(p2, z2, state, xs)
    if plots:
        _plot(xs, pred.mean, pred.variance, x, y, f"large_n_svgp_{n}.png")
    return {"elbo_trace": trace, "noise": noise2, "z": z2, "xs": xs,
            "mean": pred.mean, "variance": pred.variance}


def _plot(xs, mean, var, x, y, name):
    from gpx_torch.plots import _plt

    plt = _plt()
    OUT.mkdir(exist_ok=True)
    fig, ax = plt.subplots(figsize=(9, 4))
    g = xs[:, 0].cpu().numpy()
    m = mean.detach().cpu().numpy()
    s = np.sqrt(np.maximum(var.detach().cpu().numpy(), 0.0))
    x, y = x.cpu().numpy(), y.cpu().numpy()
    sub = max(len(x) // 2000, 1)
    ax.plot(x[::sub, 0], y[::sub], ".", ms=2, alpha=0.3,
            label="data (subsampled)")
    ax.plot(g, m, lw=1.5, label="posterior mean")
    ax.fill_between(g, m - 1.64 * s, m + 1.64 * s, alpha=0.25,
                    label="90% band")
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(OUT / name, dpi=110)
    plt.close(fig)
    print(f"wrote {OUT / name}")


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("mode", choices=["dense", "iterative", "svgp"])
    ap.add_argument("n", nargs="?", type=int, default=None)
    ap.add_argument("--steps", type=int, default=300,
                    help="svgp: Adam steps")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    default_n = {"dense": 16384 if on_card else 1024,
                 "iterative": 32768 if on_card else 2048,
                 "svgp": 16384 if on_card else 2048}[args.mode]
    n = args.n or default_n
    if args.mode == "svgp":
        return run_svgp(n, device, not args.no_plots, args.steps)
    return {"dense": run_dense, "iterative": run_iterative}[args.mode](
        n, device, not args.no_plots)


if __name__ == "__main__":
    main()
