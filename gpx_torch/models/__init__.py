"""GP models of the port: ``gp`` (the marginal likelihood, its gradient
and prediction), ``gp_iterative`` (the matrix-free path) and ``optimize``
(type-II ML / MAP)."""

from gpx_torch.models import gp, gp_iterative, optimize

__all__ = ["gp", "gp_iterative", "optimize"]
