"""Bayesian inference over the hyperparameters — the port of the HMC slice
of ``gpx/infer``: random-walk MH (``mh``), HMC (``hmc``), dual-averaging
step sizes (``dual_averaging``), the chain runner (``base``) and the GP
entry points (``mcmc``). Chains run back to back in Python loops over torch
tensors; each leapfrog gradient is one autograd call of the lifted
log-posterior.
"""

from gpx_torch.infer import base, dual_averaging, hmc, mcmc, mh
from gpx_torch.infer.mcmc import (
    PosteriorSamples,
    sample_hmc,
    sample_hmc_log_density,
)

__all__ = [
    "base",
    "dual_averaging",
    "hmc",
    "mcmc",
    "mh",
    "PosteriorSamples",
    "sample_hmc",
    "sample_hmc_log_density",
]
