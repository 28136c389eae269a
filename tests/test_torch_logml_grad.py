"""The plain version of the port's fused gradient kernel against the JAX
package's ``logml_kernel_grads`` (interpret mode), on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

import gpx
import gpx_torch as gt
from gpx.ops.pallas_logml_grad import logml_kernel_grads
from gpx_torch.ops.cuda_logml_grad import logml_kernel_grads_reference
from gpx_torch.params import leaves

torch.set_num_threads(1)


def test_logml_grad_reference_matches_pallas(rng):
    n = 256
    x = rng.uniform(-10, 10, size=(n, 1))
    # SE(1, 2) under targets of scale 3 keeps every gradient component far
    # from a cancellation; at the bench's SE(3, 5.5) and y ~ N(0, 1) the h
    # gradient is ~-1 from terms of ~250, where gpx's f32 sum alone
    # carries ~1e-3 absolute
    y = 3.0 * rng.normal(size=n)
    k = np.asarray((gpx.se(1.0, 2.0) + gpx.white(0.5)).gram(
        jnp.asarray(x), nugget=1e-3, method="xla"))
    l = np.linalg.cholesky(k)
    l_inv = np.linalg.inv(l)
    alpha = l_inv.T @ (l_inv @ y)

    want_k, (want_tkw, want_trw) = logml_kernel_grads(
        gpx.se(1.0, 2.0) + gpx.white(0.5), jnp.asarray(x), jnp.asarray(alpha),
        jnp.asarray(l_inv), bt=64, interpret=True, with_correction=True)
    kern = (gt.se(1.0, 2.0, device="cpu", dtype=torch.float64)
            + gt.white(0.5, device="cpu", dtype=torch.float64))
    got_k, (got_tkw, got_trw) = logml_kernel_grads_reference(
        kern, torch.as_tensor(x), torch.as_tensor(alpha), torch.as_tensor(l_inv))

    got = [float(t) for t in leaves(got_k)] + [float(got_tkw), float(got_trw)]
    want = [float(t) for t in
            (want_k.kernels[0].h, want_k.kernels[0].sigma,
             want_k.kernels[1].sigma, want_tkw, want_trw)]
    # gpx accumulates in f32 at bf16x3 (~1.5e-5 per dot)
    np.testing.assert_allclose(got, want, rtol=1e-4)
