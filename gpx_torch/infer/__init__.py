"""Bayesian inference over the hyperparameters — the port of
``gpx/infer``: random-walk MH (``mh``), HMC (``hmc``), NUTS (``nuts``),
empirical HMC (``ehmc``), the conjugate Gibbs updates (``gibbs``),
dual-averaging step sizes (``dual_averaging``), the chain runner (``base``)
and the GP entry points (``mcmc``). Chains run back to back in Python loops
over torch tensors; each leapfrog gradient is one autograd call of the
lifted log-posterior.
"""

from gpx_torch.infer import (
    base, dual_averaging, ehmc, gibbs, hmc, mcmc, mh, nuts,
)
from gpx_torch.infer.mcmc import (
    PosteriorSamples,
    sample_ehmc,
    sample_ehmc_log_density,
    sample_hmc,
    sample_hmc_log_density,
    sample_mh,
    sample_mh_log_density,
    sample_mh_within_gibbs,
    sample_nuts,
    sample_nuts_log_density,
)

__all__ = [
    "base",
    "dual_averaging",
    "ehmc",
    "gibbs",
    "hmc",
    "mcmc",
    "mh",
    "nuts",
    "PosteriorSamples",
    "sample_ehmc",
    "sample_ehmc_log_density",
    "sample_hmc",
    "sample_hmc_log_density",
    "sample_mh",
    "sample_mh_log_density",
    "sample_mh_within_gibbs",
    "sample_nuts",
    "sample_nuts_log_density",
]
