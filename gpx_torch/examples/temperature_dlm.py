"""Seasonal DLM for multi-sensor temperature — examples/src/main/scala/
TemperatureDlm.scala.

The reference's flagship example, all three studies:

1. **Gibbs fit** (TemperatureDlm.scala:98-128): latent state from
   ``polynomial(1) |+| seasonal(24, 3) |+| seasonal(7*24, 3)`` (daily AND
   weekly seasonality, :83) shared across 8 sensors (:84-86), FFBS-within-
   Gibbs over (states, V, W), then forecasting from the filtered state.
2. **Smoothing study** (:256-359): RTS-smoothed state at the posterior-mean
   variances, the smoothed level plotted with intervals, and a spatial GP
   fitted by MH on the *smoothed* residuals.
3. **Conjugate-filter held-out-sensor forecast** (:361-402): filter 7
   sensors with the observation variance integrated out; one-step Student-t
   predictions for the held-out sensor with
   `gpx_torch.distributions.StudentT` intervals and a coverage check.
"""

import pathlib

import numpy as np
import torch

import gpx_torch as gt
from gpx_torch._device import resolve_device
from gpx_torch import plots
from gpx_torch.distributions import Gamma, InverseGamma, student_t_interval
from gpx_torch.examples import _common
from gpx_torch.examples.temperature import uniform_locations
from gpx_torch.infer import sample_mh
from gpx_torch.models import dlm

OUT = pathlib.Path(__file__).parent / "output"
N_SENSORS = 8


def build_model(n_sensors: int = N_SENSORS, device=None, dtype=None):
    # polynomial(1) |+| seasonal(24, 3) |+| seasonal(7*24, 3)
    # (TemperatureDlm.scala:83) — hourly data: daily + weekly cycles
    kw = dict(device=device, dtype=dtype)
    base = (dlm.polynomial(1, **kw) + dlm.seasonal(24, 3, **kw)
            + dlm.seasonal(7 * 24, 3, **kw))
    return dlm.replicate_observations(base, n_sensors)


def simulate(key, t=24 * 7 * 6):
    """Six weeks of hourly observations from the full daily+weekly model,
    the noise drawn from the generator ``key``."""
    model = build_model(device=key.device)
    d_state = model.g.shape[0]
    like = dict(device=key.device)
    w = torch.full((d_state,), 0.005, **like)
    v = torch.full((N_SENSORS,), 0.3, **like)
    x = torch.zeros(d_state, **like)
    x[0], x[1], x[7] = 12.0, 1.5, 0.8
    z_w = torch.randn((t, d_state), generator=key, **like)
    z_v = torch.randn((t, N_SENSORS), generator=key, **like)
    ys = []
    for i in range(t):
        x = model.g @ x + torch.sqrt(w) * z_w[i]
        ys.append(model.f @ x + torch.sqrt(v) * z_v[i])
    return model, torch.stack(ys)


def filter_and_forecast(model, ys, v, w, m0, c0, n_ahead):
    """The Kalman filter at fixed variances and the ``n_ahead``-step
    forecast from its last state: ``(filtered, means, covs)``."""
    filtered = dlm.kalman_filter(model, ys, v, w, m0, c0)
    means, covs = dlm.forecast(model, filtered.m[-1], filtered.c[-1], v, w,
                               n_ahead)
    return filtered, means, covs


def fit_and_forecast(args, model, ys, m0, c0, device):
    """Study 1: FFBS-within-Gibbs + forecast (TemperatureDlm.scala:98-128)."""
    prior = InverseGamma(concentration=torch.tensor(3.0, device=device),
                         scale=torch.tensor(0.5, device=device))
    result = dlm.gibbs_sample(
        _common.generator(device, args.seed + 1), model, ys, prior, prior,
        m0, c0, args.n_iters,
    )
    v_hat = result.v[args.n_iters // 2:].mean(0)
    w_hat = result.w[args.n_iters // 2:].mean(0)
    print("posterior mean V:", np.round(v_hat.cpu().numpy(), 3))
    print("posterior mean W:", np.round(w_hat.cpu().numpy(), 4))

    filtered, means, covs = filter_and_forecast(model, ys, v_hat, w_hat, m0,
                                                c0, args.forecast)
    if not args.no_plots:
        fig, ax = plots._plt().subplots(figsize=(10, 5))
        t_hist = np.arange(ys.shape[0])
        t_fc = np.arange(ys.shape[0], ys.shape[0] + args.forecast)
        ax.plot(t_hist[-240:], ys[-240:, 0].cpu().numpy(), lw=0.8,
                label="sensor 0")
        fc_m = means[:, 0].cpu().numpy()
        fc_s = np.sqrt(covs[:, 0, 0].cpu().numpy())
        ax.plot(t_fc, fc_m, color="red", label="forecast")
        ax.fill_between(t_fc, fc_m - 1.64 * fc_s, fc_m + 1.64 * fc_s,
                        alpha=0.25, color="red")
        ax.legend()
        plots.savefig(fig, OUT / "temperature_dlm_forecast.png")
        print(f"wrote {OUT}/temperature_dlm_forecast.png")
    return {"gibbs": result, "v_hat": v_hat, "w_hat": w_hat,
            "filtered": filtered, "forecast_means": means,
            "forecast_covs": covs}


def smoothing_study(args, model, ys, filtered, device):
    """Study 2 (TemperatureDlm.scala:256-359): RTS smoothing at the
    posterior-mean variances, smoothed-level plot, and a spatial GP fitted
    on the SMOOTHED residuals by MH."""
    s_means, s_covs = dlm.smooth(model, filtered)
    level = s_means[:, 0]
    level_sd = torch.sqrt(s_covs[:, 0, 0])

    if not args.no_plots:
        t = np.arange(ys.shape[0])
        lv, sd = level.cpu().numpy(), level_sd.cpu().numpy()
        fig, ax = plots._plt().subplots(figsize=(10, 5))
        ax.plot(t, ys[:, 0].cpu().numpy(), lw=0.5, alpha=0.5,
                label="sensor 0")
        ax.plot(t, lv, color="black", label="smoothed level")
        ax.fill_between(t, lv - 1.64 * sd, lv + 1.64 * sd, alpha=0.3,
                        color="gray", label="90% interval")
        ax.legend()
        plots.savefig(fig, OUT / "temperature_dlm_smoothed.png")
        print(f"wrote {OUT}/temperature_dlm_smoothed.png")

    # spatial GP on smoothed residuals (the reference fits the GP to the
    # residuals of the fitted DLM, TemperatureKriging feeds off the same
    # chain); time-averaged per-sensor residual field
    resid_mean = (ys - s_means @ model.f.T).mean(dim=0)     # (sensors,)
    locs = uniform_locations(_common.generator(device, 9), N_SENSORS,
                             [0.0, 0.0], [1.0, 1.0])
    template = gt.Parameters(
        mean=gt.zero(),
        kernel=gt.se(0.5, 0.5, device=device) + gt.white(0.3, device=device),
    )
    pr = Gamma(concentration=torch.tensor(2.0, device=device),
               rate=torch.tensor(2.0, device=device))

    def log_prior(p):
        k0, k1 = p.kernel.kernels
        return pr.logpdf(k0.h) + pr.logpdf(k0.sigma) + pr.logpdf(k1.sigma)

    post = sample_mh(
        _common.generator(device, args.seed + 2), locs, resid_mean, template,
        log_prior, n_samples=max(200, args.n_iters // 2), burn_in=100,
        n_chains=2,
    )
    medians = torch.median(post.flat.reshape(-1, 3), dim=0).values
    print("GP-on-smoothed-residuals kernel posterior medians:",
          np.round(medians.cpu().numpy(), 3))
    return {"smooth_means": s_means, "smooth_covs": s_covs,
            "residual_flat": post.flat,
            "residual_accept_rate": post.accept_rate}


def heldout_intervals(ys, m0, c0):
    """Study 3's numbers (TemperatureDlm.scala:361-402): conjugate-filter
    the first 7 sensors (observation variance integrated out), then
    one-step Student-t forecasts of the held-out 8th sensor through the
    shared latent state, each with its 90% interval; in ``ys``'s type and
    on its device."""
    like = dict(device=ys.device, dtype=ys.dtype)
    held = N_SENSORS - 1
    model7 = build_model(n_sensors=held, **like)
    f_held = build_model(**like).f[held]                    # (d_state,)
    g = model7.g
    w_star = torch.full((g.shape[0],), 0.01, **like)        # scale-free W
    prior_v = InverseGamma(concentration=torch.tensor(3.0, **like),
                           scale=torch.tensor(1.0, **like))
    res = dlm.conjugate_filter(model7, ys[:, :held], w_star, m0, c0, prior_v)

    # one-step prediction of the held-out sensor: prior state (a_t, r_t)
    # from the previous posterior, Student-t via the pre-update (a_v, b_v)
    m_prev = torch.cat([m0[None], res.m[:-1]])
    c_prev = torch.cat([c0[None], res.c_star[:-1]])
    a_v = torch.cat([prior_v.concentration[None], res.v_shape[:-1]])
    b_v = torch.cat([prior_v.scale[None], res.v_scale[:-1]])
    a = m_prev @ g.T
    r = g @ c_prev @ g.T + torch.diag(w_star)
    mean = a @ f_held
    q = torch.einsum("i,tij,j->t", f_held, r, f_held) + 1.0  # scale-free + V*
    scale = torch.sqrt((b_v / a_v) * q)
    df = 2.0 * a_v
    # both quantiles in one bisection: (2, T)
    lo, hi = student_t_interval(mean, scale, df,
                                torch.tensor([[0.05], [0.95]], **like))
    return {"mean": mean, "scale": scale, "df": df, "lo": lo, "hi": hi}


def heldout_conjugate_forecast(args, ys, m0, c0):
    """Study 3: the held-out sensor's intervals and their coverage."""
    out = heldout_intervals(ys, m0, c0)
    held = N_SENSORS - 1
    y_held = ys[:, held]
    warm = ys.shape[0] // 4                                 # filter warmup
    inside = (y_held[warm:] >= out["lo"][warm:]) & (
        y_held[warm:] <= out["hi"][warm:])
    cover = float(inside.double().mean())
    print(f"held-out sensor 90% Student-t interval coverage: {cover:.2f}")

    if not args.no_plots:
        t = np.arange(ys.shape[0])[-240:]
        lo, hi = (out[k][-240:].cpu().numpy() for k in ("lo", "hi"))
        fig, ax = plots._plt().subplots(figsize=(10, 5))
        ax.plot(t, y_held[-240:].cpu().numpy(), lw=0.7,
                label=f"sensor {held} (held out)")
        ax.plot(t, out["mean"][-240:].cpu().numpy(), color="red", lw=0.8,
                label="one-step t forecast")
        ax.fill_between(t, lo, hi, alpha=0.2, color="red",
                        label="90% t interval")
        ax.legend()
        plots.savefig(fig, OUT / "temperature_dlm_heldout.png")
        print(f"wrote {OUT}/temperature_dlm_heldout.png")
    return {**out, "coverage": cover}


def main(argv=None):
    ap = _common.parser(__doc__)
    ap.add_argument("n_iters", nargs="?", type=int, default=500)
    ap.add_argument("--forecast", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hours", type=int, default=24 * 7 * 6,
                    help="length of the simulated record (six weeks)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    OUT.mkdir(exist_ok=True)

    model, ys = simulate(_common.generator(device, args.seed), t=args.hours)
    d_state = model.g.shape[0]
    m0 = torch.zeros(d_state, device=device)
    c0 = torch.eye(d_state, device=device) * 10.0

    out = {"ys": ys, "m0": m0, "c0": c0}
    out.update(fit_and_forecast(args, model, ys, m0, c0, device))
    out.update(smoothing_study(args, model, ys, out["filtered"], device))
    out["heldout"] = heldout_conjugate_forecast(args, ys, m0, c0)
    return out


if __name__ == "__main__":
    main()
