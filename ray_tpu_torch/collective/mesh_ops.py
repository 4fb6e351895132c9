"""Named-axis collectives over the ambient mesh (the counterpart of
``ray_tpu/collective/xla_ops.py``).

JAX traces ``psum``/``all_gather``/``ppermute`` inside ``shard_map`` over
axes the mesh binds; here each rank runs the same Python and the axis name
picks the ``DeviceMesh`` dim whose process group carries the collective.
The mesh is the ambient one (``parallel.mesh.set_mesh``) or ``mesh=``,
which code that runs again under a checkpoint's recompute passes, since the
recompute runs outside the ``with`` block.

The differentiable ones are ``torch.autograd.Function``s with JAX's
transposes: ``allreduce`` (sum) leaves the gradient as it is on each rank
(each rank's replicated output is one value: a loss all-reduced and then
backpropagated from every rank gives each rank its own share),
``pvary`` is its mirror (identity forward, gradient summed over the axis:
a value replicated over the axis and used differently by each rank),
``allgather`` and ``reducescatter`` are each other's transposes,
``ppermute`` sends the gradient back along the reverse permutation and
``all_to_all`` swaps its split and concat axes.  Every rank must reach the
same collectives in the same order, forward and backward: callers keep
their autograd graphs the same shape on every rank (``torch.where`` on a
rank-dependent tensor, not a Python branch).

Transport: a group's own backend carries the tensor, except that a gloo
group cannot carry every collective for a CUDA tensor (send and receive,
reduce-scatter, all-to-all); for a gloo group a CUDA tensor is staged
through pinned host memory (``_host``), every collective alike.  An NCCL
group never stages.  On gloo a reduce-scatter is an all-reduce of which
each rank keeps its chunk.  ``traffic`` adds up what this process's
collectives moved and how long the host waited on them.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..parallel.mesh import current_mesh

AxisName = Union[str, Sequence[str]]

#: This process's collectives since the caller last zeroed it: calls,
#: bytes of the tensors handed in, and host seconds from the call to its
#: result.  A gloo collective (staged through host memory) returns when
#: the data has arrived, so its seconds are the transport's; an NCCL one
#: returns once queued on the stream, so there they are enqueue time only.
traffic = {"calls": 0, "bytes": 0, "seconds": 0.0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(frozen=True)
class _Axis:
    """One mesh dim as this rank sees it: its process group, size, this
    rank's index along it and the global ranks in axis order."""

    group: dist.ProcessGroup
    size: int
    index: int
    ranks: Tuple[int, ...]


def _axis(axis: str, mesh: Optional[DeviceMesh]) -> _Axis:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise NameError(f"unbound axis name: {axis}")
    group = mesh.get_group(axis)
    return _Axis(group, mesh.size(mesh.mesh_dim_names.index(axis)),
                 mesh.get_local_rank(axis),
                 tuple(dist.get_process_group_ranks(group)))


def _names(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis: AxisName, *, mesh: Optional[DeviceMesh] = None) -> int:
    """Size of the named axis (the product over a tuple of axes); raises
    ``NameError`` when no ambient mesh binds it, as JAX does outside
    ``shard_map``."""
    n = 1
    for a in _names(axis):
        n *= _axis(a, mesh).size
    return n


def axis_index(axis: AxisName, *, mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's index along the named axis (row-major over a tuple)."""
    idx = 0
    for a in _names(axis):
        ax = _axis(a, mesh)
        idx = idx * ax.size + ax.index
    return idx


# ---------------------------------------------------------------- transport


def _host(t: torch.Tensor, ax: _Axis) -> bool:
    """Whether ``t`` goes through pinned host memory on ``ax``'s group."""
    return t.is_cuda and dist.get_backend(ax.group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _staged(t: torch.Tensor, ax: _Axis):
    """(the tensor the backend takes, a function taking the backend's
    result back to ``t``'s device)."""
    t = t.contiguous()
    if not _host(t, ax):
        return t, lambda r: r
    return _to_host(t), lambda r: r.to(t.device)


def _counted(fn):
    """Add each call of ``fn`` to ``traffic``."""
    @functools.wraps(fn)
    def run(x: torch.Tensor, ax: _Axis, *args):
        t0 = time.perf_counter()
        out = fn(x, ax, *args)
        traffic["calls"] += 1
        traffic["bytes"] += x.numel() * x.element_size()
        traffic["seconds"] += time.perf_counter() - t0
        return out
    return run


def _all_reduce(x: torch.Tensor, ax: _Axis,
                op: str = "sum") -> torch.Tensor:
    buf, back = _staged(x, ax)
    buf = buf.clone() if buf.data_ptr() == x.data_ptr() else buf
    dist.all_reduce(buf, op=_OPS[op], group=ax.group)
    return back(buf)


_psum = _counted(_all_reduce)


@_counted
def _gather(x: torch.Tensor, ax: _Axis, dim: int) -> torch.Tensor:
    buf, back = _staged(x, ax)
    parts = [torch.empty_like(buf) for _ in range(ax.size)]
    dist.all_gather(parts, buf, group=ax.group)
    return back(torch.cat(parts, dim=dim))


@_counted
def _scatter_sum(x: torch.Tensor, ax: _Axis, dim: int) -> torch.Tensor:
    if x.shape[dim] % ax.size:
        raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) "
                         f"over {ax.size} ranks")
    n = x.shape[dim] // ax.size
    if dist.get_backend(ax.group) == "gloo":
        return _all_reduce(x, ax).narrow(dim, ax.index * n, n).contiguous()
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n, *src.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src, group=ax.group)
    return out.movedim(0, dim)


@_counted
def _permute(x: torch.Tensor, ax: _Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send to the perm's destination of this rank, receive from its
    source; zeros where nothing arrives (JAX's ``ppermute``)."""
    dst = [d for s, d in perm if s == ax.index]
    src = [s for s, d in perm if d == ax.index]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute {perm}: an index sends or receives "
                         f"twice")
    if src and dst and src[0] == dst[0] == ax.index:
        return x.clone()
    buf, back = _staged(x, ax)
    out = torch.zeros_like(buf)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, buf, ax.ranks[dst[0]], ax.group))
    if src:
        ops.append(dist.P2POp(dist.irecv, out, ax.ranks[src[0]], ax.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return back(out)


@_counted
def _a2a(x: torch.Tensor, ax: _Axis, split: int,
         concat: int) -> torch.Tensor:
    n = ax.size
    if x.shape[split] % n:
        raise ValueError(f"all_to_all splits dim {split} ({x.shape[split]}) "
                         f"over {n} ranks")
    # chunk j of the split dim goes to rank j; rank j's chunk comes back
    # as chunk j of the concat dim.
    chunks = x.movedim(split, 0).reshape(n, x.shape[split] // n,
                                         *x.movedim(split, 0).shape[1:])
    buf, back = _staged(chunks, ax)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=ax.group)
    got = back(out).movedim(1, split + 1)  # [n, ...x with split shrunk]
    return torch.cat(list(got.unbind(0)), dim=concat)


# ------------------------------------------------------ differentiable ops


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, op):
        ctx.n, ctx.op = ax.size, op
        if op == "mean":
            return _psum(x, ax) / ax.size
        return _psum(x, ax, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "sum":
            return g, None, None
        if ctx.op == "mean":
            return g / ctx.n, None, None
        raise NotImplementedError(f"no gradient for allreduce {ctx.op!r}")


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.ax), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.ax, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _scatter_sum(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.ax, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _permute(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return _permute(g, ctx.ax, back), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split, concat):
        ctx.ax, ctx.split, ctx.concat = ax, split, concat
        return _a2a(x, ax, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.ax, ctx.concat, ctx.split), None, None, None


def _bound(axis: AxisName, mesh) -> List[_Axis]:
    """The axes of ``axis`` with more than one rank."""
    return [ax for ax in (_axis(a, mesh) for a in _names(axis))
            if ax.size > 1]


def allreduce(x: torch.Tensor, axis: AxisName, op: str = "sum", *,
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """``psum`` / ``pmean`` / ``pmax`` / ``pmin`` over the named axis (or
    axes).  The sum's gradient is left as it is on each rank."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported reduce op {op!r}")
    for ax in _bound(axis, mesh):
        x = _AllReduce.apply(x, ax, op)
    return x


def pvary(x: torch.Tensor, axis: AxisName, *,
          mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Identity forward; the gradient is summed over the named axis (JAX's
    ``pvary``, and the transpose of ``allreduce``'s sum).  Marks a value
    that every rank of the axis holds alike but uses on its own data."""
    for ax in _bound(axis, mesh):
        x = _PVary.apply(x, ax)
    return x


def allgather(x: torch.Tensor, axis: AxisName, *, tiled: bool = True,
              gather_axis: int = 0,
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``gather_axis`` in axis order
    (``tiled``), or stack them on a new leading ``gather_axis``."""
    if not tiled:
        x = x.unsqueeze(gather_axis)
    for ax in reversed(_bound(axis, mesh)):
        x = _AllGather.apply(x, ax, gather_axis % x.ndim)
    return x


def reducescatter(x: torch.Tensor, axis: AxisName, *, scatter_axis: int = 0,
                  mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Sum over the named axis and keep this rank's chunk of
    ``scatter_axis`` (``psum_scatter(..., tiled=True)``)."""
    for ax in _bound(axis, mesh):
        x = _ReduceScatter.apply(x, ax, scatter_axis % x.ndim)
    return x


def broadcast(x: torch.Tensor, axis: str, root: int = 0, *,
              mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Every rank takes root's value along ``axis``: mask-then-sum, one
    allreduce instead of a world-sized all-gather."""
    keep = axis_index(axis, mesh=mesh) == root
    return allreduce(x if keep else torch.zeros_like(x), axis, mesh=mesh)


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]],
             *, mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Send ``x`` from index i to j for each (i, j) in ``perm``; an index
    that receives nothing gets zeros."""
    ax = _axis(axis, mesh)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if ax.size == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, ax, perm)


def shift(x: torch.Tensor, axis: str, offset: int = 1, *,
          mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Ring shift: each rank receives from (i - offset) % n."""
    n = axis_size(axis, mesh=mesh)
    return ppermute(x, axis, [(i, (i + offset) % n) for i in range(n)],
                    mesh=mesh)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int,
               concat_axis: int, *,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Chunk j of ``split_axis`` goes to rank j, and the chunks received
    are concatenated along ``concat_axis`` in rank order (tiled)."""
    ax = _axis(axis, mesh)
    if ax.size == 1:
        return x
    return _AllToAll.apply(x, ax, split_axis % x.ndim, concat_axis % x.ndim)


__all__ = ["allreduce", "pvary", "allgather", "reducescatter", "broadcast",
           "ppermute", "shift", "all_to_all", "axis_index", "axis_size",
           "traffic"]
