"""Failure detection: Cholesky of near-singular Grams with nugget
escalation — the port of ``gpx/ops/safe_chol.py``.

A failed :func:`gpx_torch.ops.chol.cholesky` returns NaN, so the detection
is by value: factor, test the result, and escalate the Tikhonov nugget by
10x until a rung succeeds. Each rung after the first runs only if every
earlier one failed (one host read per rung tried).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpx_torch.ops.chol import cholesky


class SafeCholResult(NamedTuple):
    chol: torch.Tensor
    nugget_used: torch.Tensor  # scalar: the nugget that succeeded (NaN: none)
    failed: torch.Tensor       # True if even the largest nugget failed


def chol_ok(l):
    """A factorization succeeded iff every entry is finite and every
    diagonal entry positive."""
    d = torch.diagonal(l, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(l)) & torch.all(d > 0)


def safe_cholesky(k, *, base_nugget: float = 0.0, max_escalations: int = 6,
                  start: float = 1e-8) -> SafeCholResult:
    """Cholesky with automatic nugget escalation: tries ``base_nugget``,
    then ``start * 10^i`` for ``i < max_escalations``, and keeps the first
    success. If none succeeds, ``chol`` is NaN and ``failed`` True."""
    n = k.shape[-1]
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    nuggets = [base_nugget] + [start * 10.0 ** i for i in range(max_escalations)]
    for nugget in nuggets:
        l = cholesky(k + nugget * eye)
        ok = chol_ok(l)
        if bool(ok):
            return SafeCholResult(l, torch.tensor(nugget, dtype=k.dtype,
                                                  device=k.device), ~ok)
    return SafeCholResult(torch.full_like(k, float("nan")),
                          torch.tensor(float("nan"), dtype=k.dtype,
                                       device=k.device), ~ok)
