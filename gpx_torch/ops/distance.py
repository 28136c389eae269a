"""Pairwise squared distances — the port of ``gpx/ops/distance.py``."""

from __future__ import annotations

import torch

from gpx_torch._device import as_tensor


def as_locations(x):
    """Coerce to an ``(N, D)`` tensor: 1-D input becomes ``(N, 1)``.
    Input that is not a tensor goes to the CUDA card."""
    x = as_tensor(x)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(
            f"locations must be (N,) or (N, D), got shape {tuple(x.shape)}"
        )
    return x


def check_xy(x, y, what: str = "y"):
    """Validate targets against locations; returns ``(x, y)`` with ``x``
    coerced and ``y`` on ``x``'s device."""
    x = as_locations(x)
    y = as_tensor(y, device=x.device)
    if y.ndim != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(
            f"{what} must be a length-N vector matching x's N={x.shape[0]}, "
            f"got shape {tuple(y.shape)}"
        )
    return x, y


# The most entries (rows x columns x D) of one block of broadcast
# differences: wide inputs (classification at D = 784) take row blocks, so
# that the difference tensor stays near 1 GiB in float64
_BLOCK_ENTRIES = 1 << 27


def sq_distances(x1, x2=None, *, exact: bool = False, center=None):
    """Pairwise squared Euclidean distances.

    The points are centred first (distances are translation-invariant, and
    centring keeps coordinate rounding out of r2), on ``x1``'s mean or on
    ``center`` (a ``(1, D)`` row): a block of rows of a larger set's
    distances centred as that set is has exactly its zeros. For ``D <= 8`` or
    ``exact=True`` the broadcast-difference form is used, which keeps
    coincident points at exactly 0 (White's ``r2 == 0``), in blocks of
    rows where the differences would exceed ``_BLOCK_ENTRIES``; otherwise
    the norms-plus-dot identity. The result is clamped at 0 and, in the
    symmetric case, its diagonal is exactly 0.
    """
    x1 = as_locations(x1)
    symmetric = x2 is None
    x2 = x1 if symmetric else as_locations(x2)
    if center is None:
        center = x1.mean(dim=0, keepdim=True)
    center = center.detach()
    x1 = x1 - center
    x2 = x1 if symmetric else x2 - center
    if exact or x1.shape[-1] <= 8:
        rows = max(1, _BLOCK_ENTRIES // max(x2.shape[0] * x2.shape[1], 1))
        r2 = torch.cat([_broadcast_r2(x1[i:i + rows], x2)
                        for i in range(0, x1.shape[0], rows)])
    else:
        n1 = torch.sum(x1 * x1, dim=-1)
        n2 = n1 if symmetric else torch.sum(x2 * x2, dim=-1)
        r2 = n1[:, None] + n2[None, :] - 2.0 * (x1 @ x2.T)
    r2 = torch.clamp_min(r2, 0.0)
    if symmetric:
        eye = torch.eye(r2.shape[0], dtype=torch.bool, device=r2.device)
        r2 = torch.where(eye, torch.zeros_like(r2), r2)
    return r2


def _broadcast_r2(x1, x2):
    diff = x1[:, None, :] - x2[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def distances(x1, x2=None):
    """Pairwise Euclidean distances (the reference's distanceMatrix)."""
    return torch.sqrt(sq_distances(x1, x2))


def euclidean(a, b):
    """Distance between two single locations (Location.euclidean,
    Location.scala:27-33)."""
    a, b = as_tensor(a), as_tensor(b)
    return torch.sqrt(torch.sum((a - b.to(a.device)) ** 2))


def locations_close(x1, x2, tol: float = 1e-3):
    """The ``(N, M)`` mask of pairs whose coordinates all agree within
    ``tol``: the reference's ``Eq[Location]`` (Location.scala:18-25)."""
    x1, x2 = as_locations(x1), as_locations(x2)
    return torch.all((x1[:, None, :] - x2[None, :, :].to(x1.device)).abs()
                     <= tol, dim=-1)


def match_locations(x1, x2, tol: float = 1e-3):
    """Index of the first ``x2`` row within ``tol`` of each ``x1`` row, or
    -1 (the reference's join of sensor sites to kriging grids)."""
    close = locations_close(x1, x2, tol)
    # argmax returns the first of equal maxima
    first = torch.argmax(close.to(torch.int8), dim=1)
    return torch.where(close.any(dim=1), first, -1)
