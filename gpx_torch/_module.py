"""The common base of kernels, means and ``Parameters``.

The JAX package registers frozen dataclasses as pytrees. Here each such
class is an ``nn.Module`` whose ``_fields`` names its hyperparameter tensors
(registered buffers) and sub-modules in the dataclass field order, which
:mod:`gpx_torch.params` walks to flatten and rebuild it.
"""

from __future__ import annotations

import torch
from torch import nn


class FieldModule(nn.Module):
    _fields: tuple = ()

    def __init__(self, **fields):
        super().__init__()
        for name in self._fields:
            value = fields[name]
            if isinstance(value, torch.Tensor):
                self.register_buffer(name, value)
            elif isinstance(value, tuple):
                setattr(self, name, nn.ModuleList(value))
            else:
                setattr(self, name, value)

    def _meta(self) -> dict:
        """Static (non-leaf) constructor arguments."""
        return {}
