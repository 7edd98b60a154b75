"""Collectives along one mesh axis, plain and differentiable.

The differentiable ones are Megatron's conjugate pairs, named for what
they do to a tensor that every rank of the axis holds whole
(replicated) or holds a part of:

- :func:`copy_in`   forward identity, backward all-reduce: a replicated
  tensor entering a computation whose ranks each hold a part of the
  weights, so that each rank's gradient is a partial sum;
- :func:`reduce_out` forward all-reduce, backward identity: partial
  sums leaving such a computation, replicated after it;
- :func:`gather`    forward all-gather along ``dim``, backward the
  rank's slice: parts made whole for a replicated computation;
- :func:`split`     forward the rank's slice along ``dim``, backward
  all-gather: a replicated tensor cut to the rank's part;
- :func:`reduce_split` forward the rank's slice of the sum, backward
  all-gather: ``split(reduce_out(x))`` in one collective.

:func:`relay` and :func:`relay_dims` move a tensor from one cut to
another (decode re-lays small activations and recurrent states with
them; they have no backward rule).

Each rank's part is the contiguous ``1/size`` slice at its index along
the axis, as the reference's mesh lays out a sharded dim.

The ``*_flat`` forms take a list of tensors and run one collective a
dtype over all of them, where the plain forms run one a tensor;
:func:`all_reduce_buckets` sums a list in place, a bounded bucket at a
time.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from .dist import Axis

# the tensor forms of all-gather and reduce-scatter; newer torch names
# them ``*_single`` and deprecates the old names
all_gather_tensor = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def part(n: int, size: int) -> int:
    if n % size:
        raise ValueError(f"a dim of {n} does not split over {size} ranks")
    return n // size


def local_slice(x, dim: int, axis: Axis):
    k = part(x.shape[dim], axis.size)
    return x.narrow(dim, axis.rank * k, k)


def all_gather(x, dim: int, axis: Axis):
    """The parts of every rank along ``dim``, in rank order."""
    dim %= x.ndim
    x = x.contiguous()
    # the parts stacked along dim 0, the layout every backend takes
    out = torch.empty((axis.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    all_gather_tensor(out, x, group=axis.group)
    shape = list(x.shape)
    shape[dim] *= axis.size
    return out.view((axis.size,) + tuple(x.shape)).movedim(0, dim) \
        .reshape(shape)


def reduce_scatter(x, dim: int, axis: Axis):
    """This rank's slice along ``dim`` of the sum over the axis."""
    k = part(x.shape[dim], axis.size)
    shape = list(x.shape)
    shape[dim:dim + 1] = [axis.size, k]
    stacked = x.reshape(shape).movedim(dim, 0).contiguous()
    out = torch.empty(stacked.shape[1:], dtype=x.dtype, device=x.device)
    reduce_scatter_tensor(out, stacked.flatten(0, 1), group=axis.group)
    return out


def all_reduce(x, axis: Axis, op=dist.ReduceOp.SUM):
    y = x.clone()
    dist.all_reduce(y, op=op, group=axis.group)
    return y


def relay(x, dim: int, have, want):
    """``x``, cut on ``dim`` over the axis ``have`` (None: whole), as cut
    over ``want``: an all-gather where a cut goes, the rank's slice (a
    view) where one comes, nothing where they are the same."""
    if have == want:
        return x
    if have is not None:
        x = all_gather(x, dim, have)
    return x if want is None else local_slice(x, dim, want)


def relay_dims(x, have, want):
    """:func:`relay` on every dim: ``have`` and ``want`` give an axis or
    None a dim."""
    for d, (a, w) in enumerate(zip(have, want)):
        x = relay(x, d, a, w)
    return x


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.axis).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return local_slice(x, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.axis), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return reduce_scatter(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.axis), None, None


def copy_in(x, axis: Axis):
    return _CopyIn.apply(x, axis)


def reduce_out(x, axis: Axis):
    return _ReduceOut.apply(x, axis)


def gather(x, dim: int, axis: Axis):
    return _Gather.apply(x, dim % x.ndim, axis)


def split(x, dim: int, axis: Axis):
    return _Split.apply(x, dim % x.ndim, axis)


def reduce_split(x, dim: int, axis: Axis):
    return _ReduceScatter.apply(x, dim % x.ndim, axis)


# ----------------------------------------------------------------- flat

def _landing(src: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """``view``'s values in a tensor of ``src``'s layout where the shapes
    agree: a sum over a gradient then runs in the order the no-group
    step's does, so a group of one rank computes its norm bit for bit."""
    if view.shape != src.shape:
        return view
    return torch.empty_like(src).copy_(view)


def _by_dtype(ts, idx):
    groups: Dict[torch.dtype, List[int]] = {}
    for i in idx:
        groups.setdefault(ts[i].dtype, []).append(i)
    return groups.values()


# the largest bucket an all-reduce of many tensors copies them into, as
# PyTorch DDP's default bucket cap
BUCKET_BYTES = 25 * 2 ** 20


def _dense_flat(t: torch.Tensor):
    """A 1-D view of ``t``'s elements in storage order where ``t`` covers
    one span of its storage once (a permutation of a contiguous layout,
    as autograd returns some gradients), else None."""
    order = sorted(range(t.dim()), key=lambda i: -t.stride(i))
    p = t.permute(order)
    return p.view(-1) if p.is_contiguous() else None


def all_reduce_buckets(ts: List[torch.Tensor], axis: Axis) -> None:
    """Sum every tensor of ``ts`` over the axis in place, in list order.
    Consecutive tensors of one dtype share a flat bucket of at most
    :data:`BUCKET_BYTES`, whose sum is copied back into each tensor in
    its own layout; a tensor of a bucket's size or more is reduced where
    it lies.  So the reduction holds one bucket beyond the tensors, and
    a later sum over a tensor runs in the order its layout gives, as
    without a group."""
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=axis.group)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        bucket.clear()

    for t in ts:
        n = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype
                       or size + n > BUCKET_BYTES):
            flush()
            size = 0
        flat = _dense_flat(t) if n >= BUCKET_BYTES else None
        if flat is not None:
            dist.all_reduce(flat, group=axis.group)
            continue
        bucket.append(t)
        size += n
    if bucket:
        flush()


def all_gather_flat(ts, dims, axis: Axis):
    """The full tensors of the parts ``ts[i]`` sharded on ``dims[i]``,
    one all-gather a dtype; each full tensor is contiguous and owns its
    storage (the flat buffer is freed on return)."""
    out = [None] * len(ts)
    for group in _by_dtype(ts, range(len(ts))):
        flat = torch.cat([ts[i].reshape(-1) for i in group])
        got = torch.empty(axis.size * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        all_gather_tensor(got, flat, group=axis.group)
        got = got.view(axis.size, -1)
        off = 0
        for i in group:
            t, n = ts[i], ts[i].numel()
            shape = list(t.shape)
            shape[dims[i]] *= axis.size
            out[i] = torch.empty(shape, dtype=t.dtype, device=t.device)
            out[i].copy_(got[:, off:off + n].reshape((axis.size,) + t.shape)
                         .movedim(0, dims[i]).reshape(shape))
            off += n
    return out


def reduce_scatter_flat(ts, dims, axis: Axis):
    """This rank's part along ``dims[i]`` of the sum of ``ts[i]`` over
    the axis, one reduce-scatter a dtype."""
    out = [None] * len(ts)
    for group in _by_dtype(ts, range(len(ts))):
        pieces, shapes = [], []
        for i in group:
            t, d = ts[i], dims[i]
            shape = list(t.shape)
            shape[d:d + 1] = [axis.size, part(t.shape[d], axis.size)]
            p = t.reshape(shape).movedim(d, 0)
            shapes.append(p.shape[1:])
            pieces.append(p.reshape(axis.size, -1))
        stacked = torch.cat(pieces, dim=1)
        got = torch.empty(stacked.shape[1], dtype=stacked.dtype,
                          device=stacked.device)
        reduce_scatter_tensor(got, stacked.reshape(-1), group=axis.group)
        off = 0
        for i, shape in zip(group, shapes):
            n = int(np.prod(shape))
            out[i] = _landing(ts[i], got[off:off + n].view(shape))
            off += n
    return out
