"""Multi-device scale-out on ``torch.distributed`` — the port of
``gpx/parallel`` (SURVEY.md §2.4).

The reference's only parallelism is 2 MCMC chains on JVM threads
(SimulatedGp.scala:163-165). Here the axes of a ``DeviceMesh`` are
first-class:

* ``chains``: independent chains, split over the ranks;
* ``data``: the Gram matrix, its factor and the matvec row-sharded over
  the ranks, with the collectives of :mod:`gpx_torch.parallel.comm`.

One program runs on every rank (launch with ``torchrun`` on a host with
several cards, or :func:`gpx_torch.parallel.dryrun.dryrun_multichip`,
which starts its own ranks). A function the JAX package calls once on
global arrays is called by every rank of the mesh with the same
arguments, and every rank gets the same replicated result.
"""

from gpx_torch.parallel.dist_chol import (
    distributed_back_solve,
    distributed_cholesky,
    distributed_forward_solve,
    distributed_half_logdet,
    distributed_logml,
    distributed_logml_value_and_grad,
    distributed_predict,
)
from gpx_torch.parallel.dist_matvec import distributed_gram_matvec
from gpx_torch.parallel.mesh import make_mesh
from gpx_torch.parallel.sharded import (
    sharded_gram,
    sharded_logml,
    sharded_predict,
    sample_chains_sharded,
    sample_mh_2d,
)

__all__ = [
    "distributed_back_solve",
    "distributed_cholesky",
    "distributed_forward_solve",
    "distributed_gram_matvec",
    "distributed_half_logdet",
    "distributed_logml",
    "distributed_logml_value_and_grad",
    "distributed_predict",
    "make_mesh",
    "sharded_gram",
    "sharded_logml",
    "sharded_predict",
    "sample_chains_sharded",
    "sample_mh_2d",
]
