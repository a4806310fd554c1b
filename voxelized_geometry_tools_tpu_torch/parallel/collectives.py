"""The collectives of the sharded functions, on ``torch.distributed``.

Each is the counterpart of one ``lax`` collective of the JAX package's
``parallel/sharded.py`` and returns a new tensor:

* :func:`all_reduce` is ``lax.psum`` (and min / max);
* :func:`all_to_all` is ``lax.all_to_all(..., tiled=True)``: the
  contiguous chunks of the split axis go one to each rank through
  ``all_to_all_single``, and the chunk from rank ``i`` lands at block ``i``
  of the concat axis;
* :func:`reduce_scatter` is ``lax.psum_scatter(..., tiled=True)``:
  a reduce-scatter of the tensor with the scatter axis moved to the
  front;
* :func:`all_gather` is the all-gather of a tiled axis (what ``shard_map``
  does to an input whose layout differs from its in-spec);
* :func:`ppermute_from_next` is ``lax.ppermute`` with the perm ``s + 1 ->
  s`` (``batch_isend_irecv``): rank ``s`` receives rank ``s + 1``'s
  tensor; with ``wrap`` the last rank receives rank 0's, else zeros.

Transport (:class:`.mesh_utils.Mesh`): with NCCL the tensors stay on the
card. With gloo and a CUDA tensor every collective copies its input to
host memory, runs there and copies the result back. When the caller has
given the mesh a ``stats`` (:class:`.mesh_utils.CollectiveStats`), each
call adds its bytes sent, its wall time (device synchronized before and
after) and the bytes it staged to it under its name; without one a
collective synchronizes nothing beyond what its transport needs.

:class:`AllGather` is the all-gather as an autograd function, whose
backward pass is the reduce-scatter of the gradient: the gradient of a
replicated copy of slabs, summed over ranks, cut back into slabs.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .mesh_utils import Mesh

Tensor = torch.Tensor

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def _dist():
    import torch.distributed as dist
    return dist


def _reduce_scatter_fn(dist):
    """``reduce_scatter_single``, or ``reduce_scatter_tensor`` on a PyTorch
    that predates it (2.13 renamed it and warns at each call of the old
    name); the same for the all-gather."""
    return getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor


def _all_gather_fn(dist):
    return getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _nbytes(x: Tensor) -> int:
    return x.numel() * x.element_size()


@contextlib.contextmanager
def _counted(mesh: Mesh, name: str, x: Tensor):
    """Adds the call's bytes sent and wall time (staging included) to
    ``mesh.stats``, and with host staging the bytes copied to the host and
    back: the input, and the result the body appends to the yielded
    list. Does nothing when the mesh has no stats."""
    result = []
    if mesh.stats is None:
        yield result
        return
    _sync(mesh)
    t0 = time.perf_counter()
    yield result
    _sync(mesh)
    staged = _nbytes(x) + _nbytes(result[0]) if mesh.host_staged else 0
    mesh.stats.add(name, _nbytes(x), (time.perf_counter() - t0) * 1e3,
                   staged)


def _staged(mesh: Mesh, x: Tensor) -> Tensor:
    """``x`` where the transport reads it: contiguous (laid out on its own
    device), in host memory when the mesh stages through it."""
    x = x.detach().contiguous()
    return x.to("cpu") if mesh.host_staged else x


def _back(mesh: Mesh, x: Tensor) -> Tensor:
    return x.to(mesh.device) if mesh.host_staged else x


def all_reduce(x: Tensor, mesh: Mesh, op: str = "sum") -> Tensor:
    """The elementwise sum (or ``"min"``, ``"max"``) of ``x`` over the
    ranks, on every rank."""
    dist = _dist()
    with _counted(mesh, "all_reduce", x) as result:
        buf = _staged(mesh, x).clone()
        dist.all_reduce(buf, op=getattr(dist.ReduceOp, _OPS[op]),
                        group=mesh.group)
        out = _back(mesh, buf)
        result.append(out)
    return out


def all_to_all(x: Tensor, mesh: Mesh, split_axis: int,
               concat_axis: int) -> Tensor:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``: block
    ``j`` of ``split_axis`` goes to rank ``j``, and rank ``i``'s block
    lands at block ``i`` of ``concat_axis``."""
    dist = _dist()
    n = mesh.size
    if split_axis == concat_axis:
        raise ValueError("split_axis and concat_axis must differ")
    if x.shape[split_axis] % n:
        raise ValueError(f"the mesh axis size {n} must divide axis "
                         f"{split_axis} ({x.shape[split_axis]})")
    with _counted(mesh, "all_to_all", x) as result:
        y = x.movedim(split_axis, 0)
        rest = tuple(y.shape[1:])
        y = _staged(mesh, y.reshape((n, y.shape[0] // n) + rest))
        out = torch.empty_like(y)
        dist.all_to_all_single(out, y, group=mesh.group)
        out = _back(mesh, out)
        result.append(out)
    # out[i]: rank i's block, the split axis at dim 1. Put the split axis
    # back, then the source rank just before the concat axis, and merge.
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return out.reshape(shape).contiguous()


def reduce_scatter(x: Tensor, mesh: Mesh, scatter_axis: int) -> Tensor:
    """``lax.psum_scatter(x, scatter_dimension=scatter_axis, tiled=True)``:
    rank ``r`` keeps block ``r`` of ``scatter_axis`` of the sum over
    ranks."""
    dist = _dist()
    n = mesh.size
    if x.shape[scatter_axis] % n:
        raise ValueError(f"the mesh axis size {n} must divide axis "
                         f"{scatter_axis} ({x.shape[scatter_axis]})")
    with _counted(mesh, "reduce_scatter", x) as result:
        y = _staged(mesh, x.movedim(scatter_axis, 0))
        out = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]),
                          dtype=y.dtype, device=y.device)
        _reduce_scatter_fn(dist)(out, y, group=mesh.group)
        out = _back(mesh, out)
        result.append(out)
    return out.movedim(0, scatter_axis).contiguous()


def all_gather(x: Tensor, mesh: Mesh, axis: int) -> Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order, on
    every rank."""
    dist = _dist()
    n = mesh.size
    with _counted(mesh, "all_gather", x) as result:
        y = _staged(mesh, x.movedim(axis, 0))
        out = torch.empty((n * y.shape[0],) + tuple(y.shape[1:]),
                          dtype=y.dtype, device=y.device)
        _all_gather_fn(dist)(out, y, group=mesh.group)
        out = _back(mesh, out)
        result.append(out)
    return out.movedim(0, axis).contiguous()


def ppermute_from_next(x: Tensor, mesh: Mesh, wrap: bool) -> Tensor:
    """Rank ``s`` receives rank ``s + 1``'s ``x``: ``lax.ppermute`` with
    ``perm=[(s + 1, s)]``. With ``wrap`` the last rank receives rank 0's
    (``perm=[(i, (i - 1) % n)]``); without it, zeros."""
    dist = _dist()
    n, r = mesh.size, mesh.rank
    if n == 1:
        return x.clone() if wrap else torch.zeros_like(x)
    with _counted(mesh, "ppermute", x) as result:
        send = _staged(mesh, x)
        recv = torch.zeros_like(send)
        ops = []
        dst, src = (r - 1) % n, (r + 1) % n
        if wrap or r > 0:
            ops.append(dist.P2POp(dist.isend, send, dst, group=mesh.group))
        if wrap or r < n - 1:
            ops.append(dist.P2POp(dist.irecv, recv, src, group=mesh.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = _back(mesh, recv)
        result.append(out)
    return out


class AllGather(torch.autograd.Function):
    """:func:`all_gather` whose backward pass reduce-scatters the gradient
    along the same axis: the gradient of a replicated tensor made from
    shards, summed over the ranks that use it."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.mesh, ctx.axis), None, None
