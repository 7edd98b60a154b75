"""Loop-aware analysis of one traced step: the port's counterpart of the
JAX package's ``launch/hlo_analysis.py``.

XLA's ``compiled.cost_analysis()`` counts a while-loop body once, so the
reference parses the compiled HLO text, recovers each loop's trip count
and propagates it through the call graph.  PyTorch compiles no HLO, but
eager dispatch is unrolled by nature: every layer, every step of a
recurrence and every remat recompute passes through the dispatcher.  So
one traced step gives what the reference's trip-count propagation
recovers.  :func:`analyze_step` runs ``fn(*args)`` once on tensors of
the ``meta`` device, which carry shapes and dtypes and no data (no card
and no memory needed; the training step runs no CUDA kernel, and a
kernel wrapper refuses a meta tensor), and counts, from a dispatch mode
below autograd:

- ``flops``: 2·M·N·K over the matmul family, the reference's ``dot``
  rule; a convolution is 2 × output elements × 64, the reference's rough
  ``convolution`` rule, so the two analyzers count the same thing;
- ``bytes_written``: the output bytes of every op that is not a view
  (the reference's HBM write-traffic proxy);
- ``collectives``: payload bytes by kind under the reference's names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute`` for send/recv) plus a ``total``.  The payload
  is the bytes the op writes, as ``Instr.out_bytes`` counts an HLO
  collective's output: for point-to-point the received buffer;
- ``peak_bytes``: the peak of live bytes (the storages alive at once,
  each from its first write to its release), arguments included — the
  counterpart of XLA's ``memory_analysis()`` temp + argument + output.

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
                 "writes", "mutated")

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
    step the same way (``result()`` gives the same dict)."""

    def __init__(self, snapshot_at: Optional[int] = None):
        super().__init__()
        self.flops = 0.0
        self.bytes_written = 0.0
        self.collectives: Dict[str, float] = {}
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

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = (n, weakref.ref(st, lambda _, k=key:
                                              self._free(k)))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
        if self.snapshot_at is not None:
            self._what[key] = (str(self._func or "argument"),
                               tuple(t.shape), t.dtype)
            if self.at_peak is None and self.live >= self.snapshot_at:
                groups: Dict[tuple, List[int]] = {}
                for k, w in self._what.items():
                    g = groups.setdefault(w, [0, 0])
                    g[0] += self._storages[k][0]
                    g[1] += 1
                self.at_peak = sorted(((n, c) + w for w, (n, c)
                                       in groups.items()),
                                      key=lambda e: e[0], reverse=True)

    def _free(self, key: int) -> None:
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live -= entry[0]
            self._what.pop(key, None)

    # the cyclic collector frees what a cycle holds at a moment that
    # depends on the process's allocation history; it is paused while the
    # mode counts, so the peak of live bytes depends on the step alone
    def __enter__(self):
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
            self.collectives[op.collective] = \
                self.collectives.get(op.collective, 0.0) + sum(
                    _nbytes(t) for t in _written(op, args, kwargs, out))
        if op.writes:
            for t in _written(op, args, kwargs, out):
                self.bytes_written += _nbytes(t)
                self.track(t)
        return out


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
    storages, so that the live bytes are the kernel's)."""

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
            _MEMO[key] = [(o.shape, o.stride(), o.dtype, o.device)
                          for o in outs] \
                if all(map(_plain_storage, outs)) else False
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


def analyze_step(fn, args, *, world_size: int = 1, rank: int = 0,
                 peak_top: int = 0) -> Dict[str, float]:
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
    groups of most bytes, largest first.
    """
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
            def meta(x):
                if isinstance(x, (ShapeDtype, torch.Tensor)):
                    return torch.empty(x.shape, dtype=x.dtype, device=META)
                return x
            def count(counter):
                margs = tree_map(meta, args)
                for _, t in tree_leaves_with_paths(margs):
                    if isinstance(t, torch.Tensor):
                        counter.track(t)
                with counter:
                    out = fn(*margs)
                del out, margs
                return counter
            got = count(_MetaCounter()).result()
            if peak_top:
                again = count(_MetaCounter(snapshot_at=int(
                    got["peak_bytes"])))
                if again.at_peak is None:
                    raise RuntimeError(
                        f"the second run peaked at {again.peak} bytes, "
                        f"below the first's {got['peak_bytes']:.0f}")
                got["at_peak"] = again.at_peak[:peak_top]
            return got
        finally:
            _GROUP.pop("group", None)
            if world_size > 1 and dist.is_initialized():
                dist.destroy_process_group()
            sys.excepthook = hook


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
