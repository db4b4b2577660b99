"""The collectives the port calls, on one axis of a `parallel/mesh.Mesh`:
the port's stand-in for the collectives XLA inserts for the JAX
package's shardings and `shard_map`s.

Plain collectives (no autograd): `all_reduce`, `all_gather` along a
dimension, `reduce_scatter` along a dimension, `ring_shift` (JAX's
`ppermute` by one step around the axis, as one `batch_isend_irecv`) and
`broadcast_object`. Each is a no-op on an axis of size 1.

Where a gradient flows through a collective it is a
`torch.autograd.Function`. The model code follows Megatron's convention:
a value that every rank of an axis computes alike ("replicated") has the
same gradient on every rank of it, so
- `reduce_from` (the row-parallel all-reduce) has the identity as its
  backward, and `copy_to` (the column-parallel input) all-reduces in its
  backward;
- `gather(..., backward="slice")` (the vocab-parallel logits, the
  embedding's features, a leaf that a replicated block gathers over
  'model') takes this rank's slice of the gradient, and
  `gather(..., backward="sum")` (ZeRO-3's gather over 'data', whose ranks
  compute different losses) reduce-scatters it;
- `RingShift`'s backward is the reverse shift, as `ppermute` transposes.

A gloo group carries CUDA tensors through pinned host memory (the
one-card machine runs two ranks on one device over gloo, `chip_smoke.py`
phase 35); NCCL takes them as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tokenpacker_tpu_torch.parallel.mesh import Axis


def _active(axis: Axis | None) -> bool:
    return axis is not None and axis.size > 1


def _staged(axis: Axis, t: torch.Tensor) -> bool:
    return t.is_cuda and axis.backend == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(t: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The sum over the axis, a new tensor."""
    t = t.contiguous().clone()
    if not _active(axis):
        return t
    if _staged(axis, t):
        h = _host(t)
        dist.all_reduce(h, group=axis.group)
        return t.copy_(h)
    dist.all_reduce(t, group=axis.group)
    return t


def all_gather(t: torch.Tensor, dim: int, axis: Axis | None) -> torch.Tensor:
    """Every rank's t concatenated along `dim` in the axis's index order."""
    if not _active(axis):
        return t
    src = t.contiguous()
    if _staged(axis, src):
        src = _host(src)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter(t: torch.Tensor, dim: int, axis: Axis | None) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum over the axis (an
    all-reduce and a slice on gloo, which has no reduce-scatter)."""
    if not _active(axis):
        return t
    if axis.backend == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // axis.size,) + src.shape[1:], dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, src, group=axis.group)
        return out.movedim(0, dim)
    return all_reduce(t, axis).chunk(axis.size, dim=dim)[axis.index].contiguous()


def ring_shift(tensors: tuple, axis: Axis | None, step: int = 1) -> tuple:
    """Each rank sends `tensors` to the rank `step` further along the axis
    (cyclically) and receives those of the rank `step` before it: JAX's
    `ppermute` with perm [(i, (i + step) % n)], as one batch_isend_irecv."""
    if not _active(axis):
        return tuple(tensors)
    n = axis.size
    to = axis.ranks[(axis.index + step) % n]
    frm = axis.ranks[(axis.index - step) % n]
    staged = any(_staged(axis, t) for t in tensors)
    srcs = [(_host(t) if staged else t.contiguous()) for t in tensors]
    outs = [torch.empty_like(s) for s in srcs]
    ops = [dist.P2POp(dist.isend, s, to, group=axis.group) for s in srcs]
    ops += [dist.P2POp(dist.irecv, o, frm, group=axis.group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tuple(o.to(t.device) for o, t in zip(outs, tensors))


def broadcast_object(obj, axis: Axis | None, src_index: int = 0):
    """`obj` of the axis's rank `src_index` on every rank of the axis."""
    if not _active(axis):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=axis.ranks[src_index], group=axis.group,
                               device=torch.device("cpu") if axis.backend == "gloo" else None)
    return box[0]


# -- under autograd ---------------------------------------------------------


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.axis), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, backward):
        ctx.dim, ctx.axis, ctx.backward = dim, axis, backward
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, dy):
        if ctx.backward == "sum":
            dx = reduce_scatter(dy, ctx.dim, ctx.axis)
        else:
            dx = dy.chunk(ctx.axis.size, dim=ctx.dim)[ctx.axis.index]
        return dx, None, None, None


class RingShift(torch.autograd.Function):
    """`ring_shift` by +1 under autograd (all tensors in one exchange); its
    backward shifts the gradients by -1."""

    @staticmethod
    def forward(ctx, axis, *tensors):
        ctx.axis = axis
        return ring_shift(tensors, axis, 1)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + ring_shift(grads, ctx.axis, -1)


def reduce_from(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """All-reduce over the axis; the gradient passes unchanged (g)."""
    return _ReduceFrom.apply(x, axis) if _active(axis) else x


def copy_to(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The identity; the gradient is all-reduced over the axis (f)."""
    return _CopyTo.apply(x, axis) if _active(axis) else x


def gather(x: torch.Tensor, dim: int, axis: Axis | None, backward: str = "slice") -> torch.Tensor:
    """all_gather along `dim`; the gradient is this rank's slice
    (backward="slice") or the reduce-scatter of it ("sum")."""
    return _Gather.apply(x, dim, axis, backward) if _active(axis) else x


def ring(axis: Axis | None, *tensors):
    """`RingShift` by +1 (a tuple of the received tensors)."""
    if not _active(axis):
        return tuple(tensors)
    return RingShift.apply(axis, *tensors)
