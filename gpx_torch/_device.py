"""Device and precision policy of the port.

Entry points run on the CUDA card unless the caller asks for the CPU, by
passing CPU tensors or ``device="cpu"``. A request for the card on a machine
without one raises; nothing continues quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`, defaulting to the CUDA card.
    Raises ``RuntimeError`` when the card is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gpx_torch runs on the CUDA card by default and none is "
            "available; pass device='cpu' (or CPU tensors) to run on the CPU"
        )
    return dev


def as_tensor(v, *, device=None, dtype=None) -> torch.Tensor:
    """A tensor on ``device`` (default: the card). Python numbers take
    ``dtype`` or torch's default float type; arrays keep their own type
    unless ``dtype`` is given."""
    if isinstance(v, torch.Tensor):
        dev = v.device if device is None else resolve_device(device)
        return v.to(device=dev, dtype=dtype or v.dtype)
    dev = resolve_device(device)
    if dtype is None and isinstance(v, (int, float)):
        dtype = torch.get_default_dtype()
    return torch.as_tensor(v, dtype=dtype, device=dev)


def full_fp32() -> None:
    """Run float32 products in full float32: the JAX package asks for
    ``Precision.HIGHEST`` on these, and TF32 keeps about three digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
