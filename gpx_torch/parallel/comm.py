"""The collectives of :mod:`gpx_torch.parallel`: the counterparts of the
``lax.axis_index``, ``lax.all_gather`` and ``lax.psum`` that the JAX
package calls inside ``shard_map``, over the process group of one axis of
a :class:`torch.distributed.device_mesh.DeviceMesh`.

Every rank runs the same program (SPMD). A value is either a rank's own
rows or replicated: every rank of the axis holds the same tensor.

**Gradients.** :func:`all_gather` and :func:`psum` are
``torch.autograd.Function``\\ s whose backward passes are the transposes of
the whole program's linear maps: ``all_gather`` (every rank receives the
concatenation of every rank's rows) transposes to a reduce-scatter of the
sum, and ``psum`` (every rank receives the sum of every rank's tensor) to
an all-reduce of the sum. Each rank seeds the same replicated loss once, so
each rank's backward pass carries ``d`` (the axis size) times its share of
the global cotangent; a parameter that entered replicated gets its
gradient as the sum over the axis of the ranks' partials divided by ``d``
(:func:`psum_each` of them, then the division). The JAX package reaches
the same numbers with ``psum``'s transpose as a broadcast plus an implicit
``psum`` wherever a replicated value meets a rank's own rows; here no such
meeting point needs marking. Where a rank's loss is its own partial sum
and not a replicated value (the matrix-free contractions), its gradients
are summed over the axis with no division.

**Order.** A rank's backward pass must run its collectives in the same
order as every other rank's, or they pair wrongly or wait for ever. The
autograd engine orders nodes by what each rank's graph holds, and the
graphs differ between ranks (a rank past the panel's rows gathers zeros
and uses nothing of the result). So autograd collectives run only inside
:func:`ordered`: each takes the previous collective's token (an empty
tensor) and gives the next one its own, so the backward pass runs them in
the reverse of the forward order on every rank, including those whose
output a rank does not use. ``ordered().seal(loss)`` ties the last token
to the loss.

**Transport.** Over NCCL the collectives run on the tensors where they
are. Over gloo (ranks that share one card, or CPU tensors) a CUDA tensor
is staged through pinned host memory and back; the compute stays where
the tensors are. The choice is made from the group's backend at each call
(:func:`_staged`).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_ORDER = threading.local()


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``mesh[axis]`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_size(mesh, axis: str) -> int:
    """The number of ranks on ``mesh[axis]``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _staged(group, t) -> bool:
    """Whether a collective of ``t`` goes through host memory: a CUDA
    tensor over a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t):
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t)


def _reduce(t, group):
    """The sum over ``group`` of ``t`` (a new tensor)."""
    if _staged(group, t):
        h = _host(t)
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _gather(t, group):
    """Every rank's ``t`` concatenated along dim 0 (a new tensor)."""
    shape = (dist.get_world_size(group) * t.shape[0], *t.shape[1:])
    if _staged(group, t):
        out = torch.empty(shape, dtype=t.dtype, pin_memory=True)
        dist.all_gather_into_tensor(out, _host(t), group=group)
        return out.to(t.device)
    out = t.new_empty(shape)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def _scatter_sum(t, group):
    """This rank's block of rows of the sum of every rank's ``t``."""
    shape = (t.shape[0] // dist.get_world_size(group), *t.shape[1:])
    if _staged(group, t):
        out = torch.empty(shape, dtype=t.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(out, _host(t), group=group)
        return out.to(t.device)
    out = t.new_empty(shape)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, token, group):
        ctx.group = group
        return _gather(t, group), token.new_empty((0,))

    @staticmethod
    def backward(ctx, g, _):
        return _scatter_sum(g, ctx.group), g.new_empty((0,)), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, token, group):
        ctx.group = group
        return _reduce(t, group), token.new_empty((0,))

    @staticmethod
    def backward(ctx, g, _):
        return _reduce(g, ctx.group), g.new_empty((0,)), None


def _order(t):
    """The :func:`ordered` scope that records a collective of ``t`` for
    autograd, or ``None`` where nothing is recorded. Inside a scope every
    collective is recorded while grad mode is on, whether or not this
    rank's ``t`` needs a gradient: another rank's may."""
    scope = getattr(_ORDER, "scope", None)
    if not torch.is_grad_enabled():
        return None
    if scope is None:
        if t.requires_grad:
            raise RuntimeError(
                "a collective recorded for autograd must run inside "
                "gpx_torch.parallel.comm.ordered(): otherwise the ranks' "
                "backward passes may run their collectives in different "
                "orders")
        return None
    if scope.token is None:
        scope.token = torch.empty((0,), dtype=t.dtype, device=t.device,
                                  requires_grad=True)
    return scope


def all_gather(t, mesh, axis: str, *, dim: int = 0):
    """Every rank's ``t`` concatenated along ``dim`` in axis order
    (``lax.all_gather(..., tiled=True)``); the same on every rank."""
    group = mesh.get_group(axis)
    moved = t.movedim(dim, 0) if dim else t
    order = _order(t)
    if order is not None:
        out, order.token = _AllGather.apply(moved, order.token, group)
    else:
        out = _gather(moved, group)
    return out.movedim(0, dim) if dim else out


def psum(t, mesh, axis: str):
    """The sum over ``mesh[axis]`` of every rank's ``t`` (``lax.psum``);
    the same on every rank."""
    group = mesh.get_group(axis)
    order = _order(t)
    if order is not None:
        out, order.token = _Psum.apply(t, order.token, group)
        return out
    return _reduce(t, group)


def reduce_scatter(t, mesh, axis: str):
    """Rank ``i``'s block of rows of the sum over ``mesh[axis]`` of every
    rank's ``t`` (``lax.psum_scatter(..., tiled=True)``), outside
    autograd."""
    return _scatter_sum(t, mesh.get_group(axis))


def psum_each(tensors, mesh, axis: str):
    """Each tensor summed over ``mesh[axis]``, in one collective: the
    gradient of a replicated parameter from the ranks' partials."""
    if not tensors:
        return []
    flat = _reduce(torch.cat([t.reshape(-1) for t in tensors]),
                   mesh.get_group(axis))
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def value_and_grads(fn, tensors, mesh, axis: str):
    """``(fn(ts), d fn / d ts)`` at ``ts = tensors``, for a replicated
    scalar ``fn`` whose program runs collectives over ``mesh[axis]``:
    autograd inside :func:`ordered`, then each gradient summed over the
    axis and divided by its size (module docstring, "Gradients"). Every
    rank of the axis calls it with the same tensors."""
    ps = [t.detach().requires_grad_() for t in tensors]
    with torch.enable_grad(), ordered() as order:
        value = order.seal(fn(ps))
        value.backward()
    d = axis_size(mesh, axis)
    grads = psum_each([torch.zeros_like(p) if p.grad is None else p.grad
                       for p in ps], mesh, axis)
    return value.detach(), [g / d for g in grads]


class _Order:
    token = None

    def seal(self, loss):
        """``loss`` with the last collective's token tied to it (adds an
        exact 0), so that every rank's backward pass reaches every
        collective."""
        return loss if self.token is None else loss + self.token.sum()


@contextlib.contextmanager
def ordered():
    """The scope in which collectives may be recorded for autograd (module
    docstring, "Order")."""
    outer = getattr(_ORDER, "scope", None)
    _ORDER.scope = _Order()
    try:
        yield _ORDER.scope
    finally:
        _ORDER.scope = outer
