"""Matmul-precision policy — the port of ``gpx/utils/precision.py``.

The JAX package traces covariance recursions under
``jax.default_matmul_precision("highest")``. Here the counterpart is TF32
off for the call: cuBLAS's float32 products and cuDNN's convolutions then
run in full float32. The package's own entry points already call
:func:`gpx_torch._device.full_fp32`; this decorator is for a caller's
code that must not run in TF32 whatever the process's flags are.
"""

from __future__ import annotations

import functools

import torch


def highest_matmuls(fn):
    """Run ``fn`` with TF32 off for matmul and cuDNN, restoring the
    previous flags on exit, an exception included."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        matmul = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn

    return wrapped
