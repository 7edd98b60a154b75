"""Parameters made whole just in time for ``fsdp`` (ZeRO-3): the port's
counterpart of the all-gathers that XLA places in the JAX package's
sharded step.

A rank holds its parts of the parameters (``shardings.param_pspec``'s
"fsdp" policy, or a rules plan's cuts over "data", whose cuts over
"model" the model computes on as they are).  The model takes the parameters of one unit at a time
through :func:`~repro_torch.parallelism.context.use`: the embedding, the
final norm, the unembedding, and each block of a layer group (one
repeat of a scanned group).  :class:`ParamGather` makes that unit's
parts whole in one flat all-gather, whose backward reduce-scatters the
unit's gradients in one flat collective, so each rank's gradient is its
part of the sum over the ranks.

Nothing keeps a unit whole past its use.  Under remat the checkpointed
repeat gathers again when the backward recomputes it.  Without remat,
autograd would keep every whole weight that it saves for the backward;
a saved-tensor hook keeps the rank's part in its place, and the
backward gathers it again when it needs it, as PyTorch's FSDP reshards
after the forward.  So a rank holds its parts, one unit whole at a
time, and the activations.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Optional

import torch

from ..models.params import tree_map
from . import collectives as C
from .dist import Axis


class _Gather(torch.autograd.Function):
    """Forward: the whole tensors of ``parts`` (sharded on ``dims``), one
    all-gather a dtype.  Backward: this rank's part of the sum of their
    gradients over the axis, one reduce-scatter a dtype."""

    @staticmethod
    def forward(ctx, axis, dims, *parts):
        ctx.axis, ctx.dims = axis, dims
        return tuple(C.all_gather_flat(list(parts), dims, axis))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(
            C.reduce_scatter_flat(list(grads), ctx.dims, ctx.axis))


class ParamGather:
    """The gatherer of one fsdp step over the rank's parameter ``leaves``
    (the tensors the model is given), ``dims[i]`` being the dim leaf i
    is sharded on (None: replicated, used as it is)."""

    def __init__(self, axis: Axis, leaves: List[torch.Tensor],
                 dims: List[Optional[int]]):
        self.axis = axis
        self._dim = {id(t): d for t, d in zip(leaves, dims) if d is not None}
        # storage of a whole tensor (its StorageImpl's address: a meta
        # tensor has one too, where its data pointer is 0) -> (the
        # tensor, weakly; the rank's part; its dim)
        self._wholes: Dict[int, tuple] = {}

    def __call__(self, tree, r: Optional[int] = None):
        parts, dims, picks = [], [], []

        def collect(t):
            d = self._dim.get(id(t))
            if d is None:
                return
            if r is None or d == 0:
                # no repeat, or a stacked leaf cut on its layers dim:
                # made whole, then indexed
                parts.append(t)
                dims.append(d)
                picks.append(r)
            else:
                parts.append(t[r])
                dims.append(d - 1)
                picks.append(None)

        tree_map(collect, tree)
        wholes = _Gather.apply(self.axis, tuple(dims), *parts) \
            if parts else ()
        for w, p, d in zip(wholes, parts, dims):
            self._wholes[w.untyped_storage()._cdata] = (
                weakref.ref(w), p.detach(), d)
        it = iter(zip(wholes, picks))

        def place(t):
            if id(t) not in self._dim:
                return t if r is None else t[r]
            w, pick = next(it)
            return w if pick is None else w[pick]

        return tree_map(place, tree)

    # ------------------------------------------------ saved-tensor hooks
    def _pack(self, t):
        if t.layout is not torch.strided or t.numel() == 0:
            return t
        key = t.untyped_storage()._cdata
        entry = self._wholes.get(key)
        if entry is None:
            return t
        whole = entry[0]()
        if whole is None:                 # freed; the address is reused
            del self._wholes[key]
            return t
        if t.dtype != whole.dtype:
            return t
        return (entry[1], entry[2], t.shape, t.stride(), t.storage_offset())

    def _unpack(self, saved):
        if isinstance(saved, torch.Tensor):
            return saved
        part, dim, shape, stride, offset = saved
        whole = C.all_gather(part, dim, self.axis).contiguous()
        return whole.as_strided(shape, stride, offset)

    @contextlib.contextmanager
    def saved_as_parts(self):
        """Autograd keeps the rank's part of every whole weight that the
        forward inside this context saves, and gathers it again in the
        backward."""
        with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                      self._unpack):
            yield
