"""Device meshes over the ranks of ``torch.distributed`` — the port of
``gpx/parallel/mesh.py``, plus the process group they stand on."""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gpx_torch._device import resolve_device

# a rank that dies makes the others raise after this long instead of
# waiting for ever
TIMEOUT_S = 120


def init_process_group(rank: int, world_size: int, store_dir: str, *,
                       backend: str, timeout_s: float = TIMEOUT_S) -> None:
    """Join the default process group through a file store in
    ``store_dir`` (no network port): ``backend="nccl"`` where each rank has
    its own card, ``"gloo"`` for CPU ranks or ranks that share a card."""
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(device=None, **axis_sizes: int) -> DeviceMesh:
    """``make_mesh(chains=2, data=4)``: a 2 x 4 mesh over the first 8 ranks
    of the initialised world, its dimensions named as the keywords. One size
    of -1 is inferred from the world size. The mesh's device type is the
    card's unless ``device`` asks for the CPU. Every rank of the world
    calls it (the axes' process groups are made collectively)."""
    names = tuple(axis_sizes)
    sizes = list(axis_sizes.values())
    n_ranks = dist.get_world_size()
    if sizes.count(-1) == 1:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n_ranks // known
    total = math.prod(sizes)
    if total > n_ranks:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"ranks, have {n_ranks}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(total).reshape(sizes),
                      mesh_dim_names=names)


@contextlib.contextmanager
def world(device=None):
    """The world's size inside the ``with`` block: the initialised world as
    it is; else, under ``torchrun`` (``WORLD_SIZE`` set), the world it
    describes; else this process alone, through a file store. NCCL for the
    card, gloo for the CPU. A world this opens is destroyed at the block's
    end. How a program that runs alone or under ``torchrun`` alike reaches
    its mesh."""
    if dist.is_initialized():
        yield dist.get_world_size()
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    store_dir = None
    if "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    else:
        store_dir = tempfile.mkdtemp(prefix="gpx_torch_world_")
        init_process_group(0, 1, store_dir, backend=backend)
    try:
        yield dist.get_world_size()
    finally:
        dist.destroy_process_group()
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
