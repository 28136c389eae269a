"""GP models of the port: ``gp`` (the marginal likelihood, its gradient
and prediction), ``gp_iterative`` (the matrix-free path), ``optimize``
(type-II ML / MAP), the sparse models ``sparse`` (SGPR), ``svgp`` and
``svgp_mo`` (multi-output SVGP), the structured ones ``multioutput``
(ICM / LMC), ``multioutput_iterative`` (matrix-free ICM / LMC) and
``gridgp`` (separable kernels on a lattice), ``classify`` (softmax-Laplace
classification), and the state-space models ``dlm`` (dynamic linear
models) and ``dlmgp`` (a DLM with GP spatial residuals)."""

from gpx_torch.models import (
    classify,
    dlm,
    dlmgp,
    gp,
    gp_iterative,
    gridgp,
    multioutput,
    multioutput_iterative,
    optimize,
    sparse,
    svgp,
    svgp_mo,
)

__all__ = [
    "classify", "dlm", "dlmgp", "gp", "gp_iterative", "gridgp", "multioutput",
    "multioutput_iterative", "optimize", "sparse", "svgp", "svgp_mo",
]
