"""Stage timing and device traces — the port of ``gpx/utils/profiling.py``.

The reference has no profiling at all (stray printlns only,
DualAveraging.scala:92). Here: wall-clock stage timing that synchronises
the card at each stage's edges (CUDA launches return before the work is
done), a ``torch.profiler`` trace of the CPU and the card, and a per-stage
breakdown of the exact GP's hot path (Gram / Cholesky / solve / gradient).
"""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path
from typing import Callable

import torch

from gpx_torch._device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulates per-stage wall-clock timings across repetitions, the
    card synchronised before and after each stage where ``device`` (default:
    the card) is one; nothing is synchronised on the CPU."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.times: dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = [f"{'stage':<28}{'mean ms':>10}{'min ms':>10}{'count':>7}"]
        for name, ts in self.times.items():
            ms = [t * 1e3 for t in ts]
            lines.append(
                f"{name:<28}{sum(ms)/len(ms):>10.2f}{min(ms):>10.2f}{len(ms):>7}"
            )
        return "\n".join(lines)


def _device_of(tree) -> torch.device:
    """The card where any tensor of ``tree`` lives there, else the CPU."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            if node.device.type == "cuda":
                return node.device
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.nn.Module):
            stack.extend(node.buffers())
    return torch.device("cpu")


def timeit(fn: Callable, *args, reps: int = 10, warmup: int = 1, **kwargs):
    """Mean seconds of ``fn(*args, **kwargs)`` over ``reps`` calls after
    ``warmup``, synchronised as :class:`StageTimer` synchronises (the card
    where the result lives there). Returns ``(mean_seconds,
    last_result)``."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    _sync(_device_of((args, kwargs, result)))
    t0 = time.perf_counter()
    for _ in range(reps):
        result = fn(*args, **kwargs)
    _sync(_device_of((args, kwargs, result)))
    return (time.perf_counter() - t0) / reps, result


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """A ``torch.profiler`` trace of the CPU and (where ``device``,
    default the card, is one) the card around the block, exported as a
    Chrome trace, ``log_dir/trace.json``. Yields the profiler, whose
    ``key_averages()`` sums device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync(dev)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def profile_gp_stages(params, x, y, *, nugget: float = 1e-3, reps: int = 5,
                      device=None):
    """Per-stage timing of the exact-GP hot path (SURVEY.md §3.3) on
    ``device`` (default: the card): ``gram``, ``cholesky``,
    ``triangular_solve``, ``tri_inverse``, ``chol_inv`` (the fused
    factorization, where :func:`gpx_torch.models.gp._fused_gate` takes the
    fused route; the JAX package's ``pallas_chol_inv``) and
    ``logml_value_and_grad``. Returns the :class:`StageTimer`."""
    from gpx_torch.models import gp
    from gpx_torch.ops.chol import cholesky, forward_solve, tri_inverse_lower
    from gpx_torch.ops.cuda_chol import chol_inv
    from gpx_torch.ops.distance import as_locations
    from gpx_torch.params import leaves, unflatten

    dev = resolve_device(device)
    params = unflatten(params, [t.to(dev) for t in leaves(params)])
    x = as_locations(torch.as_tensor(x, device=dev))
    y = torch.as_tensor(y, device=dev)
    timer = StageTimer(dev)

    def gram():
        return params.kernel.gram(x, nugget=nugget)

    k = gram()
    l = cholesky(k)
    ci = None
    if gp._fused_gate(params.kernel, x):
        pad = (-x.shape[0]) % math.lcm(gp.TILE, gp.LEAF)
        k_p = gp._pad_spd(k, pad) if pad else k

        def ci():
            return chol_inv(k_p)

    def vag():
        return gp.logml_value_and_grad(params, x, y, nugget=nugget)

    # one warm-up call of each stage: the first launch of a CUDA kernel
    # loads its library
    _ = (forward_solve(l, y), tri_inverse_lower(l), vag(),
         ci() if ci is not None else None)
    for _ in range(reps):
        with timer.stage("gram"):
            gram()
        with timer.stage("cholesky"):
            cholesky(k)
        with timer.stage("triangular_solve"):
            forward_solve(l, y)
        with timer.stage("tri_inverse"):
            tri_inverse_lower(l)
        if ci is not None:
            with timer.stage("chol_inv"):
                ci()
        with timer.stage("logml_value_and_grad"):
            vag()
    return timer
