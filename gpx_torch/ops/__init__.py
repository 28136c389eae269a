"""Numerics of the port: distances, Gram, Cholesky, and the CUDA kernels
with their plain versions (``cuda_*`` modules, sources in ``csrc/``)."""
