"""Loop-aware analysis of one traced step: the port's counterpart of the
JAX package's ``launch/hlo_analysis.py``.

XLA's ``compiled.cost_analysis()`` counts a while-loop body once, so the
reference parses the compiled HLO text, recovers each loop's trip count
(``_trip_count``) and multiplies the body's cost by it through the call
graph (``computation_multipliers``).  PyTorch compiles no HLO: every op
of a step passes through the dispatcher.  :func:`analyze_step` runs
``fn(*args)`` once on tensors of the ``meta`` device, which carry shapes
and dtypes and no data (no card and no memory needed; the training step
runs no CUDA kernel, and a kernel wrapper refuses a meta tensor), and
counts, from a dispatch mode below autograd:

- ``flops``: 2·M·N·K over the matmul family, the reference's ``dot``
  rule; a convolution is 2 × output elements × 64, the reference's rough
  ``convolution`` rule, so the two analyzers count the same thing;
- ``bytes_written``: the output bytes of every op that is not a view
  (the reference's HBM write-traffic proxy), except that an in-place scatter
  counts what it writes into its destination, not the destination
  (:data:`_SCATTER`), as the reference counts a dynamic-update-slice's
  update operand (``_effective_out_bytes``);
- ``collectives``: payload bytes by kind under the reference's names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute`` for send/recv) plus a ``total``.  The payload
  is the bytes the op writes, as ``Instr.out_bytes`` counts an HLO
  collective's output: for point-to-point the received buffer;
- ``peak_bytes``: the peak of live bytes (the storages alive at once,
  each from its first write to its release), arguments included — the
  counterpart of XLA's ``memory_analysis()`` temp + argument + output.

Beside the totals the counter keeps a record by op: the bytes each (op,
shape, dtype) wrote and each collective's payload by (kind, shape,
dtype, group size), from which :func:`top_writers` and
:func:`collective_details` give the reference's "where is the memory
term coming from" views of a step.

The time loops of the port's models are the counterparts of the
reference's ``lax.scan`` calls, and run through ``models.scan.scan``:
the sLSTM recurrence (``models.recurrent.slstm_block``), the
batched-gradient sLSTM scan's forward, its recompute and its reverse
loop (``models.slstm_scan``), the chunked mLSTM's chunk loop and both
loops of ``blockwise_attention`` (``models.blockwise``).  The trip
count is the loop's own ``n``, known before it runs.  On meta tensors
the counter (:class:`_MetaCounter`) counts a loop of n >= 5 trips from
four of them: the first (its carry comes from outside and needs no
gradient, so autograd skips products there) and the last (its outputs
leave the loop) run as they are; trip 1's forward and trip n - 2's
backward are each counted once and charged n - 4 more times, flops,
bytes, collectives and the records' bytes and counts alike; loops
nested in a charged trip multiply.  Autograd's engine runs a graph's
nodes in the reverse order of their creation, so a trip's backward runs
as one window, which pre-hooks on the grad_fns of the trips' outputs
delimit; a remat recompute runs the loop again and is counted the same
way.  The live bytes the charged trips would hold stay counted (each
storage of trip 1 carries its counterparts' bytes to where it is
freed), so ``peak_bytes`` is the full replay's.  The ops an analysis
dispatches (``dispatched_ops``) no longer grow with the sequence length.
On tensors with data every trip runs, op for op: :class:`StepCounter`
on real tensors replays every step and is the tests' oracle.

``world_size > 1`` opens a default process group of the ``"fake"``
backend (``torch.testing._internal.distributed.fake_pg``) as ``rank``
for the call: its collectives return at once and leave their meta
buffers as they are, so one process stands in for rank ``rank`` of a
job of any size.  Analyses are serialised by a module lock, because the
default group is process-global.

Speed: most meta kernels are Python reference implementations, so the
dispatch mode stands in for them where it can: an in-place op leaves
its meta tensor as it is, and a functional op's output shapes are
memoised by its arguments' shapes, strides and values (shared by every
analysis of the process).  ``FakeTensorMode`` over fake CPU tensors
would give the same counts with a Python wrapper around every tensor
and op.

The framework-neutral functions (:data:`KNOWN_COLLECTIVES`,
:func:`collective_link_factor`, :func:`link_seconds`,
:func:`scale_analysis`) are the reference's verbatim.
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from ..models import scan
from ..models.params import ShapeDtype, tree_leaves_with_paths, tree_map

_LOCK = threading.Lock()
_GROUP: Dict[str, object] = {}

aten = torch.ops.aten
META = torch.device("meta")

# 2 * (output elements) * (contracted size); the contracted size is the
# last dim of the left operand at argument index `lhs`
_MATMUL_LHS = {
    aten.mm.default: 0, aten.bmm.default: 0, aten.mv.default: 0,
    aten.addmm.default: 1, aten.baddbmm.default: 1, aten.addmv.default: 1,
    aten.dot.default: 0, aten.vdot.default: 0,
}
_CONVOLUTION = (aten.convolution.default, aten.convolution_backward.default)
# ops that allocate and write nothing (a storage counts as live from
# its first write)
_NO_WRITE = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default}
# c10d op name -> the reference's collective kind
_COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast",
    "reduce_": "reduce",
    "gather_": "gather",
    "scatter_": "scatter",
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _arg(args, kwargs, i: int, name: str):
    return args[i] if i < len(args) else kwargs.get(name)


def _index_put_bytes(args, kwargs) -> int:
    """``values`` broadcast to the indexed shape: the broadcast shape of
    the index tensors times the dims they leave whole.  A bool index
    counts its true elements where it lies on the CPU (elsewhere that
    would need a sync, and ``values`` counts as it is)."""
    dest = args[0]
    idx = _arg(args, kwargs, 1, "indices")
    shapes, whole, d = [], 1, 0
    for t in idx:
        if t is None:
            whole *= dest.shape[d]
            d += 1
        elif t.dtype in (torch.bool, torch.uint8):
            if t.device.type != "cpu":
                return _arg(args, kwargs, 2, "values").numel() \
                    * dest.element_size()
            shapes.append((int(t.count_nonzero()),))
            d += t.dim()
        else:
            shapes.append(tuple(t.shape))
            d += 1
    whole *= math.prod(dest.shape[d:])
    return math.prod(torch.broadcast_shapes(*shapes)) * whole \
        * dest.element_size()


def _masked_scatter_bytes(args, kwargs) -> int:
    """The mask's true count (broadcast to the destination) where it
    lies on the CPU; elsewhere that would need a sync, and ``source``
    counts."""
    dest, mask = args[0], _arg(args, kwargs, 1, "mask")
    if mask.device.type == "cpu":
        return int(mask.expand(dest.shape).count_nonzero()) \
            * dest.element_size()
    return _nbytes(_arg(args, kwargs, 2, "source"))


def _operand(i: int, name: str):
    return lambda args, kwargs: _nbytes(_arg(args, kwargs, i, name))


# in-place scatters: the bytes one writes into its destination (its
# first argument), in place of the destination's.  The out-of-place
# ``index_put`` is not one: it writes a fresh tensor whole.
_SCATTER = {
    aten.index_put_.default: _index_put_bytes,
    aten._index_put_impl_.default: _index_put_bytes,
    aten.index_copy_.default: _operand(3, "source"),
    aten.index_add_.default: _operand(3, "source"),
    aten.scatter_.src: _operand(3, "src"),
    aten.scatter_.value: lambda args, kwargs: (
        _arg(args, kwargs, 2, "index").numel() * args[0].element_size()),
    aten.scatter_add_.default: _operand(3, "src"),
    aten.scatter_reduce_.two: _operand(3, "src"),
    aten.masked_scatter_.default: _masked_scatter_bytes,
}


# in-place ops that change a tensor's metadata, not only its data
_RESTRIDE = {"resize_", "resize_as_", "set_", "as_strided_", "squeeze_",
             "unsqueeze_", "transpose_", "t_", "swapaxes_", "swapdims_",
             "detach_", "_resize_output_"}
# the shapes of a functional op's outputs (False: not to be stood in
# for), by the op and its arguments' shapes, strides, dtypes and other
# values (shared by every analysis; cleared past _MEMO_MAX entries)
_MEMO: Dict[tuple, list] = {}
_MEMO_MAX = 500_000


def _sig(x):
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(map(_sig, x))
    return x


def _op_kind(func) -> str:
    """"view", "inplace" (writes its first argument, shape unchanged),
    "functional" (fresh tensor outputs only) or "other"."""
    sch = func._schema
    if func.is_view:
        return "view"
    if func.namespace != "aten":
        return "other"
    args, rets = sch.arguments, sch.returns
    if any(a.alias_info is not None for a in args):
        name = sch.name.split("::")[-1]
        first = args[0].alias_info if args else None
        if (len(rets) == 1 and first is not None and first.is_write
                and rets[0].alias_info is not None
                and sch.overload_name != "out"
                and not any(a.alias_info is not None for a in args[1:])
                and name not in _RESTRIDE):
            return "inplace"
        return "other"
    if rets and all(str(r.type) == "Tensor" and r.alias_info is None
                    for r in rets):
        return "functional"
    return "other"


class _Op:
    """What the counting mode needs of an op, read once from its
    schema."""
    __slots__ = ("kind", "lhs", "conv", "c10d", "send", "collective",
                 "writes", "mutated", "scatter", "pg", "name")

    def __init__(self, func):
        sch = func._schema
        name = sch.name.split("::")[-1]
        self.kind = _op_kind(func)
        self.lhs = _MATMUL_LHS.get(func)
        self.conv = func in _CONVOLUTION
        self.c10d = func.namespace == "c10d"
        self.send = self.c10d and name == "send"
        self.collective = _COLLECTIVE_KINDS.get(name) if self.c10d \
            else None
        self.writes = self.kind != "view" and func not in _NO_WRITE
        self.mutated = [(i, a.name) for i, a in enumerate(sch.arguments)
                        if a.alias_info is not None and a.alias_info.is_write]
        self.scatter = _SCATTER.get(func)
        self.pg = next((i for i, a in enumerate(sch.arguments)
                        if a.name == "process_group"), None)
        self.name = str(func)


def _group_size(op: _Op, args) -> int:
    """The size of the process group a c10d op runs over."""
    if op.pg is None or op.pg >= len(args):
        return dist.get_world_size()
    return dist.ProcessGroup.unbox(args[op.pg]).size()


def _written(op: _Op, args, kwargs, out) -> List[torch.Tensor]:
    """The tensors an op writes.  A c10d op writes its first argument
    (the output buffers; the tensors an all-reduce or a recv fills) and
    returns a Work; ``send`` writes nothing.  An aten op writes its
    outputs and the arguments its schema marks as mutated."""
    if op.c10d:
        return [] if op.send else _tensors(args[0])
    got = _tensors(out)
    for i, name in op.mutated:
        for t in _tensors(args[i] if i < len(args) else kwargs.get(name)):
            if all(t is not u for u in got):
                got.append(t)
    return got


class StepCounter(TorchDispatchMode):
    """A dispatch mode that counts flops, bytes written, collective
    payloads and live bytes of every op below autograd, on any tensors:
    :func:`analyze_step` runs it on meta tensors, and it counts a real
    step the same way (``result()`` gives the same dict).  ``writers``
    holds the bytes written by (op, shape, dtype) and ``payloads`` each
    collective's by (kind, shape, dtype, group size), as [bytes,
    count]."""

    def __init__(self, snapshot_at: Optional[int] = None):
        super().__init__()
        self.flops = 0.0
        self.bytes_written = 0.0
        self.collectives: Dict[str, float] = {}
        self.writers: Dict[tuple, list] = {}
        self.payloads: Dict[tuple, list] = {}
        self.live = 0
        self.peak = 0
        # StorageImpl address -> (bytes, a weak reference whose callback
        # frees them)
        self._storages: Dict[int, tuple] = {}
        self._ops: Dict[object, _Op] = {}
        # with ``snapshot_at``: each live storage's (op, shape, dtype),
        # and the live bytes by (op, shape, dtype) when they first reach
        # it
        self.snapshot_at = snapshot_at
        self.at_peak: Optional[List[tuple]] = None
        self._what: Dict[int, tuple] = {}
        self._func = None
        # loop-aware counting (``models.scan``): the bytes each storage
        # carries for its charged counterparts [(loop name, bytes)], and
        # the loops now running forward or backward
        self._riders: Dict[int, List[tuple]] = {}
        self._open: Dict[str, int] = {}
        self._serial = 0
        self.dispatched = 0

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._serial += 1
        self._storages[key] = (n, weakref.ref(st, lambda _, k=key:
                                              self._free(k)), self._serial)
        self.live += n
        if self.snapshot_at is not None:
            self._what[key] = (str(self._func or "argument"),
                               tuple(t.shape), t.dtype)
        self._reach(self.live)

    def _reach(self, live: int) -> None:
        """Live bytes of ``live`` at some moment: the peak, and with
        ``snapshot_at`` the groups live when it is first reached (the
        bytes of charged loop trips as one group)."""
        if live > self.peak:
            self.peak = live
        if (self.snapshot_at is None or self.at_peak is not None
                or live < self.snapshot_at):
            return
        groups: Dict[tuple, List[int]] = {}
        for k, w in self._what.items():
            g = groups.setdefault(w, [0, 0])
            g[0] += self._storages[k][0]
            g[1] += 1
        rest = live - sum(n for n, _ in groups.values())
        if rest > 0:
            groups[("charged loop trips", (), None)] = [rest, 0]
        self.at_peak = sorted(((n, c) + w for w, (n, c) in groups.items()),
                              key=lambda e: e[0], reverse=True)

    def _free(self, key: int) -> None:
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live -= entry[0]
            self._what.pop(key, None)
        for name, n in self._riders.pop(key, ()):
            # freed outside its loop: its counterparts go with it
            if not self._open.get(name):
                self.live -= n

    # ------------------------------------------------ loop-aware counting
    #
    # ``models.scan`` runs four trips of a loop and has one trip's
    # forward and another's backward charged for the rest (see its
    # docstring).  A count in progress is the counter's record;
    # ``loop_begin`` sets it aside and starts a fresh one for the trip,
    # ``loop_end`` adds the trip's record 1 + k times back.

    def _swap_record(self, record):
        old = (self.flops, self.bytes_written, self.collectives,
               self.writers, self.payloads)
        (self.flops, self.bytes_written, self.collectives, self.writers,
         self.payloads) = record or (0.0, 0.0, {}, {}, {})
        return old

    def _add_record(self, record, k: int) -> None:
        flops, written, coll, writers, payloads = record
        self.flops += k * flops
        self.bytes_written += k * written
        for kind, n in coll.items():
            self.collectives[kind] = self.collectives.get(kind, 0.0) + k * n
        for mine, theirs in ((self.writers, writers),
                             (self.payloads, payloads)):
            for key, (n, c) in theirs.items():
                entry = mine.setdefault(key, [0, 0])
                entry[0] += k * n
                entry[1] += k * c

    def loop_window(self, name: str, step: int) -> None:
        """Open (+1) or close (-1) a window in which loop ``name`` runs
        forward or backward."""
        self._open[name] = self._open.get(name, 0) + step

    def loop_begin(self):
        """Start counting one trip apart: its record, and the live bytes
        it leaves and their peak."""
        token = (self._swap_record(None), self.live, self.peak, self._serial)
        self.peak = self.live
        return token

    def loop_end(self, token, k: int, name: str, forward: bool) -> None:
        """End the trip begun with ``token`` and charge it ``k`` more
        times, each charged trip starting where the one before left the
        live bytes.  ``forward``: the storages the trip left alive carry
        their k counterparts' bytes (see :meth:`_free`)."""
        outer, live0, peak0, serial0 = token
        record = self._swap_record(outer)
        self._add_record(record, 1 + k)
        delta, bump = self.live - live0, self.peak - live0
        self.peak = max(peak0, self.peak)
        if not k:
            return
        # the charged trips' peaks lie on a line through the trip's;
        # where the live bytes grow from trip to trip, the last is highest
        if delta > 0:
            self._reach(live0 + k * delta + bump)
        self.live += k * delta
        if not forward:
            return
        for key in reversed(self._storages):
            n, _, serial = self._storages[key]
            if serial <= serial0:
                break
            riders = self._riders.setdefault(key, [])
            riders.append((name, k * (n + sum(r[1] for r in riders))))

    # the cyclic collector frees what a cycle holds at a moment that
    # depends on the process's allocation history; it is paused while the
    # mode counts, so the peak of live bytes depends on the step alone.
    # A dispatch mode's first call in a process imports ``torch._dynamo``
    # (``TorchDispatchMode`` wraps ``__torch_dispatch__`` in
    # ``torch._disable_dynamo``), and the import leaves the frames then on
    # the stack in a cycle, their locals alive until the collector runs:
    # it is imported here, before the collector is paused.
    def __enter__(self):
        import torch._dynamo  # noqa: F401
        self._gc = gc.isenabled()
        gc.disable()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._gc:
                gc.enable()

    def result(self) -> Dict[str, float]:
        coll = dict(self.collectives)
        coll["total"] = sum(coll.values(), 0.0)
        return {"flops": self.flops, "bytes_written": self.bytes_written,
                "collectives": coll, "peak_bytes": float(self.peak)}

    def _run(self, func, op, args, kwargs):
        return func(*args, **kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.dispatched += 1
        op = self._ops.get(func)
        if op is None:
            op = self._ops[func] = _Op(func)
        out = self._run(func, op, args, kwargs)
        self._func = func
        if op.lhs is not None:
            lhs = args[op.lhs]
            k = lhs.shape[-1] if lhs.dim() else 1
            self.flops += 2.0 * math.prod(out.shape) * k
        elif op.conv:
            res = out if isinstance(out, tuple) else (out,)
            self.flops += sum(2.0 * r.numel() * 64 for r in res[:2]
                              if isinstance(r, torch.Tensor))
        elif op.collective is not None:
            got = _written(op, args, kwargs, out)
            self.collectives[op.collective] = \
                self.collectives.get(op.collective, 0.0) + sum(
                    _nbytes(t) for t in got)
            size = _group_size(op, args)
            for t in got:
                _add(self.payloads, (op.collective, tuple(t.shape),
                                     t.dtype, size), _nbytes(t))
        if op.writes:
            for i, t in enumerate(_written(op, args, kwargs, out)):
                n = op.scatter(args, kwargs) if op.scatter and i == 0 \
                    else _nbytes(t)
                self.bytes_written += n
                _add(self.writers, (op.name, tuple(t.shape), t.dtype), n)
                self.track(t)
        return out


def _add(record: Dict[tuple, list], key: tuple, n: int) -> None:
    entry = record.setdefault(key, [0, 0])
    entry[0] += n
    entry[1] += 1


def _top(record: Dict[tuple, list], k: int) -> List[tuple]:
    """(bytes, key..., count) rows of ``record``, most bytes first."""
    rows = [(n,) + key + (c,) for key, (n, c) in record.items()]
    rows.sort(key=lambda r: r[0], reverse=True)
    return rows[:k]


def _plain_storage(t: torch.Tensor) -> bool:
    """Whether ``t`` owns exactly the storage that ``empty_strided`` of
    its shape and strides would give it (offset 0, no slack)."""
    if t.storage_offset() or not t.numel():
        return t.untyped_storage().nbytes() == 0
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return t.untyped_storage().nbytes() == span * t.element_size()


class _MetaCounter(StepCounter):
    """:class:`StepCounter` on meta tensors, standing in for the meta
    kernels it can: an in-place op leaves its meta tensor as it is, and
    a functional op whose output shapes are memoised gets fresh meta
    tensors of them (only where its kernel's outputs own plain
    storages of their own, so that the live bytes are the kernel's).
    It is the loop-aware counter of ``models.scan`` while it counts."""

    def __enter__(self):
        self._loops = scan.counting(self)
        self._loops.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._loops.__exit__(None, None, None)

    def _run(self, func, op, args, kwargs):
        if op.kind == "inplace":
            return args[0]
        if op.kind != "functional":
            return func(*args, **kwargs)
        try:
            key = (func, _sig(args), _sig(tuple(kwargs.items())))
            hit = _MEMO.get(key)
        except TypeError:               # an unhashable argument
            return func(*args, **kwargs)
        if hit:
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device=device)
                    for shape, stride, dtype, device in hit]
            return outs[0] if len(outs) == 1 else tuple(outs)
        out = func(*args, **kwargs)
        if hit is None:
            if len(_MEMO) > _MEMO_MAX:
                _MEMO.clear()
            outs = _tensors(out)
            # an op whose schema says fresh but whose output is its
            # input's storage (``_unsafe_view``) is run each time
            ins = {t.untyped_storage()._cdata
                   for t in _tensors(list(args) + list(kwargs.values()))}
            _MEMO[key] = [(o.shape, o.stride(), o.dtype, o.device)
                          for o in outs] \
                if all(_plain_storage(o) and o.untyped_storage()._cdata
                       not in ins for o in outs) else False
        return out


def _fake_pg():
    try:
        from torch.testing._internal.distributed import fake_pg
    except ImportError as e:
        raise ImportError(
            f"analyze_step(world_size > 1) needs torch's fake process "
            f"group (torch.testing._internal.distributed.fake_pg), which "
            f"torch {torch.__version__} does not ship") from e
    return fake_pg


def current_group():
    """The :class:`~repro_torch.parallelism.dist.Group` of the analysis
    in progress (None at world size 1): what ``fn`` hands a
    ``BuiltJob`` to run as that rank."""
    return _GROUP.get("group")


@contextlib.contextmanager
def _session(world_size: int, rank: int):
    """The frame of one analysis: under the module's lock, as ``rank``
    of a fake default group of ``world_size`` where that is above 1,
    and with no default group left after it."""
    from ..parallelism.dist import Group
    with _LOCK:
        if dist.is_available() and dist.is_initialized():
            raise RuntimeError(
                "analyze_step opens a fake default process group, and "
                "this process already has a default group")
        # init_process_group wraps sys.excepthook with a rank prefix;
        # it is put back with the group
        hook = sys.excepthook
        if world_size > 1:
            fake_pg = _fake_pg()
            dist.init_process_group("fake", store=fake_pg.FakeStore(),
                                    rank=rank, world_size=world_size)
            _GROUP["group"] = Group(rank, world_size, META, "fake", "")
        try:
            yield
        finally:
            _GROUP.pop("group", None)
            if world_size > 1 and dist.is_initialized():
                dist.destroy_process_group()
            sys.excepthook = hook


def _counted(fn, args, counter: StepCounter) -> StepCounter:
    """``counter`` after ``fn`` ran once under it on meta tensors of
    ``args``."""
    def meta(x):
        if isinstance(x, (ShapeDtype, torch.Tensor)):
            return torch.empty(x.shape, dtype=x.dtype, device=META)
        return x
    margs = tree_map(meta, args)
    for _, t in tree_leaves_with_paths(margs):
        if isinstance(t, torch.Tensor):
            counter.track(t)
    with counter:
        out = fn(*margs)
    del out, margs
    return counter


def analyze_step(fn, args, *, world_size: int = 1, rank: int = 0,
                 peak_top: int = 0, writers_top: int = 0) -> Dict[str, float]:
    """Run ``fn(*args)`` once on meta tensors and count its work.

    ``args`` is a tree (dicts, lists, tuples) whose leaves are
    :class:`~repro_torch.models.params.ShapeDtype` or tensors (each
    made a meta tensor of its shape and dtype), or anything else
    (passed as is).  ``fn`` may build objects outside the counting,
    under ``_disable_current_modes()``.  With ``world_size > 1`` it runs
    as ``rank`` of a fake default group of that size
    (:func:`current_group`); a process that already has a default group
    raises, since the fake one would replace it.  No default group is
    left when it returns.

    ``peak_top > 0`` runs ``fn`` a second time, and adds ``at_peak``:
    the storages live when that run's live bytes first reach the first
    run's peak, grouped by the op that wrote them (or "argument"), shape
    and dtype, as (bytes, count, op, shape, dtype): the ``peak_top``
    groups of most bytes, largest first.  ``writers_top > 0`` adds
    ``top_writers``, the first run's :func:`top_writers` rows.
    """
    with _session(world_size, rank):
        counter = _counted(fn, args, _MetaCounter())
        got = counter.result()
        got["dispatched_ops"] = counter.dispatched
        if writers_top:
            got["top_writers"] = _top(counter.writers, writers_top)
        if peak_top:
            again = _counted(fn, args, _MetaCounter(snapshot_at=int(
                got["peak_bytes"])))
            if again.at_peak is None:
                raise RuntimeError(
                    f"the second run peaked at {again.peak} bytes, "
                    f"below the first's {got['peak_bytes']:.0f}")
            got["at_peak"] = again.at_peak[:peak_top]
        return got


def top_writers(fn, args, k: int = 15, *, world_size: int = 1,
                rank: int = 0) -> List[tuple]:
    """The reference's ``top_writers`` of ``fn(*args)`` run as
    :func:`analyze_step` runs it: the ``k`` (bytes, op, shape, dtype,
    count) rows of most bytes written, grouped by the op, the shape and
    the dtype of the tensor written (a scatter's rows count what it
    writes into its destination, of the destination's shape).  They sum
    to at most ``bytes_written``, and to it where every group is
    listed."""
    with _session(world_size, rank):
        return _top(_counted(fn, args, _MetaCounter()).writers, k)


def collective_details(fn, args, k: int = 10, *, world_size: int = 1,
                       rank: int = 0) -> List[tuple]:
    """The reference's ``collective_details`` of ``fn(*args)`` run as
    :func:`analyze_step` runs it: the ``k`` (payload bytes, kind, shape,
    dtype, group size, count) rows of most payload, grouped by the
    collective's kind (the reference's names), the shape and dtype of
    the buffer it fills, and the size of the group it runs over (the
    mesh axis's ranks)."""
    with _session(world_size, rank):
        return _top(_counted(fn, args, _MetaCounter()).payloads, k)


# ------------------------------------------------------- a train step

def train_step_inputs(cfg, plan, batch_size: int, seq_len: int,
                      dtype=torch.float32):
    """(params, opt_state, batch) of one rank of ``plan`` as
    :class:`~repro_torch.models.params.ShapeDtype` trees: the parameters
    and AdamW's mu and nu in ``dtype`` (fp32, as the reference's
    ``_compiled_step`` lowers them), cut to the rank's part where the
    plan shards a leaf, and the global batch of ``concrete_batch``."""
    from ..configs import concrete_batch
    from ..models.transformer import model_spec
    from ..parallelism.shardings import local_shape, param_pspec
    spec_tree = model_spec(cfg)
    sizes = dict(plan.mesh_axes)

    def part(spec):
        shape = local_shape(spec.shape, param_pspec(spec, plan), sizes) \
            if plan.n_devices > 1 else spec.shape
        return ShapeDtype(tuple(shape), dtype)

    params = tree_map(part, spec_tree)
    opt = {"mu": params, "nu": params,
           "step": ShapeDtype((), torch.int32)}
    batch = {k: ShapeDtype(tuple(v.shape), v.dtype)
             for k, v in concrete_batch(cfg, batch_size, seq_len,
                                        device="cpu").items()}
    return params, opt, batch


def analyze_train_step(cfg, plan, opt_cfg, batch_size: int, seq_len: int,
                       *, rank: int = 0) -> Dict[str, float]:
    """:func:`analyze_step` of one train step of ``plan`` as ``rank``:
    the step ``BuiltJob`` runs on that rank, on its part of the
    parameters and optimizer state and its slice of the batch."""
    from ..parallelism.build import BuiltJob

    def step(params, opt, batch):
        # the BuiltJob and its device mesh are built real, uncounted
        with _disable_current_modes():
            built = BuiltJob(cfg, plan, opt_cfg, device=META,
                             group=current_group())
        return built.step(params, opt, built.place_batch(batch))

    return analyze_step(step, train_step_inputs(cfg, plan, batch_size,
                                                seq_len),
                        world_size=plan.n_devices, rank=rank)


# ------------------------------------------------- roofline conversion
#
# Effective bytes-on-wire per device for the standard ring algorithms,
# as a multiple of the payload bytes ``analyze()`` reports.  These map a
# collective KIND onto the link-bandwidth term of the roofline: an
# all-reduce of P bytes on n devices moves ~2P(n-1)/n bytes through
# each device's interconnect, an all-gather/reduce-scatter ~P(n-1)/n,
# a permute exactly P.  Kinds missing from this table make a combo
# LOW-CONFIDENCE (the profiler escalates it to a real trial).

KNOWN_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute")


def collective_link_factor(kind: str, n_devices: int) -> Optional[float]:
    """Bytes-on-wire multiplier for one collective kind at ``n_devices``
    (None for kinds the ring model does not cover)."""
    n = max(int(n_devices), 1)
    ring = (n - 1) / n if n > 1 else 0.0
    return {
        "all-reduce": 2.0 * ring,
        "all-gather": ring,
        "reduce-scatter": ring,
        "all-to-all": ring,
        "collective-permute": 1.0 if n > 1 else 0.0,
    }.get(kind.replace("-start", ""))


def link_seconds(collectives: Dict[str, float], n_devices: int,
                 link_bw: float) -> Tuple[float, List[str]]:
    """Interconnect seconds for an ``analyze()`` collectives dict, plus
    the list of UNFIT kinds (present in the HLO but absent from the
    ring-model table) the caller should treat as low confidence."""
    total = 0.0
    unfit: List[str] = []
    for kind, payload in collectives.items():
        if kind == "total":
            continue
        f = collective_link_factor(kind, n_devices)
        if f is None:
            unfit.append(kind)
            total += payload / max(link_bw, 1e-9)   # conservative: 1x
        else:
            total += payload * f / max(link_bw, 1e-9)
    return total, unfit


def scale_analysis(analysis: Dict[str, float], n_from: int, n_to: int,
                   *, work_scales: bool = True) -> Dict[str, float]:
    """Rescale an ``analyze()`` result from a mesh over ``n_from``
    devices to ``n_to`` devices WITHOUT recompiling.

    The compiled module is SPMD — ``analyze()`` counts one device's
    program — so where shapes permit (the sharded axis divides evenly,
    which every registered technique guarantees inside its
    ``search_space``), per-device FLOPs and HBM traffic scale as
    ``n_from/n_to`` (the same global work divided over more devices)
    while each collective's PAYLOAD per device stays constant (grad
    all-reduce moves the full gradient, FSDP gathers the full params,
    TP reduces the full activations — none depend on the ring size; the
    ring-size dependence lives in :func:`collective_link_factor`).
    ``work_scales=False`` keeps per-device work constant instead (e.g.
    a technique that replicates rather than shards the batch).
    """
    s = (n_from / n_to) if work_scales else 1.0
    out = dict(analysis)
    out["flops"] = analysis["flops"] * s
    out["bytes_written"] = analysis["bytes_written"] * s
    out["collectives"] = dict(analysis.get("collectives", {"total": 0.0}))
    out["scaled_from"] = float(n_from)
    out["scaled_to"] = float(n_to)
    return out
