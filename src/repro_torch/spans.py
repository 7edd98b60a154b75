"""Named spans and counters inside the training step, read back from a
profiled window.

Off unless a profiler runs (``torch.autograd._profiler_enabled()``):
then :func:`span` returns one shared null context, allocates nothing,
records nothing and registers no hook, and :func:`count` returns at
once.  Under a profiler (``torch.profiler.profile``) a span

- opens a host range of its name through ``_RecordFunctionFast``, of
  FUNCTION scope.  A user-scope range (``record_function``) would be
  mirrored by Kineto onto the card as a device annotation, which a
  reader of the trace's device events would take for a kernel.  Either
  way the range shows among the host events of the profiler's trace,
  on the clock of its device events;
- records a CUDA timing event on the current stream at entry and at
  exit (a span whose tensor lies on the CPU keeps host times only);
- notes its phase: ``forward``, or ``recompute`` where it runs inside a
  backward pass (a remat block's second forward under
  ``torch.utils.checkpoint``).

``span(name, x)`` wraps a differentiable layer whose input is ``x``:
the function that its ``with`` gives is applied to the layer's output
``y`` and returns it.  In the forward phase, and only under a profiler,
it registers a pre-hook on ``y.grad_fn`` (the start of the layer's
``backward`` occurrence) and a hook on ``x`` (its end, once ``x``'s
gradient is whole).  Neither changes a gradient.  A recompute registers
nothing: its graph is thrown away.

``count(name, value)`` adds a host number or a device tensor (never
read back in the step) to a counter, in the forward phase only; guard
the work of computing ``value`` with :func:`counting`.

:func:`record` gives what the latest profiled window recorded: each
occurrence in the order of its start, with its host times (seconds) and
device times (milliseconds on the stream, both from the window's first
occurrence), and the counters' totals.  A window starts at the first
span under a profiler after a span ran without one or after
:func:`record` was called.  The record is the process's own: the spans
sit deep in the model's calls, where a recorder passed in would change
every signature, and a process profiles one window at a time.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch._C._profiler import _RecordFunctionFast

FORWARD, RECOMPUTE, BACKWARD = "forward", "recompute", "backward"

_profiling = torch.autograd._profiler_enabled
_graph_task = torch._C._current_graph_task_id


class Occurrence(NamedTuple):
    name: str
    phase: str
    host_start: float                # s from the window's first occurrence
    host_end: float
    device_start: Optional[float]    # ms on the stream; None on the CPU
    device_end: Optional[float]


class Record(NamedTuple):
    spans: List[Occurrence]          # in the order of their starts
    counters: Dict[str, float]


class _Open:
    """One occurrence while its window runs."""
    __slots__ = ("name", "phase", "cuda", "seq", "h0", "h1", "e0", "e1")

    def __init__(self, name, phase, cuda):
        self.name, self.phase, self.cuda = name, phase, cuda
        self.seq = self.h0 = self.h1 = self.e0 = self.e1 = None

    def start(self, *_):
        self.seq = next(_seq)
        self.h0 = time.perf_counter_ns()
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()

    def end(self, *_):
        if self.cuda:
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e1.record()
        self.h1 = time.perf_counter_ns()


class _Window:
    def __init__(self):
        self.spans: List[_Open] = []
        self.counters: Dict[str, object] = {}
        self.result: Optional[Record] = None


_seq = itertools.count()
_window: Optional[_Window] = None
_fresh = True       # the next span under a profiler opens a new window


def _current() -> _Window:
    global _window, _fresh
    if _fresh:
        _window, _fresh = _Window(), False
    return _window


def _identity(y):
    return y


class _Null:
    __slots__ = ()

    def __enter__(self):
        return _identity

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Span:
    __slots__ = ("name", "x", "cuda", "occ", "rf")

    def __init__(self, name, x):
        self.name, self.x = name, x
        self.cuda = x.is_cuda if x is not None \
            else torch.cuda.is_initialized()

    def __enter__(self):
        phase = FORWARD if _graph_task() == -1 else RECOMPUTE
        self.occ = _Open(self.name, phase, self.cuda)
        _current().spans.append(self.occ)
        self.rf = _RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.occ.start()
        x = self.x
        if phase == FORWARD and x is not None and x.requires_grad:
            return _Backward(self.name, x, self.cuda)
        return _identity

    def __exit__(self, *exc):
        self.occ.end()
        self.rf.__exit__(*exc)
        return False


class _Backward:
    """Applied to a layer's output: its backward occurrence, timed from
    the output's ``grad_fn`` to the input's gradient."""
    __slots__ = ("name", "x", "cuda")

    def __init__(self, name, x, cuda):
        self.name, self.x, self.cuda = name, x, cuda

    def __call__(self, y):
        x, self.x = self.x, None
        if y.grad_fn is not None:
            occ = _Open(self.name, BACKWARD, self.cuda)
            _current().spans.append(occ)
            y.grad_fn.register_prehook(occ.start)
            x.register_hook(occ.end)
        return y


def span(name: str, x: Optional[torch.Tensor] = None):
    """A context for the work of ``name``; ``x``: the layer's input, for
    its backward occurrence (see the module's docstring)."""
    if _profiling():
        return _Span(name, x)
    global _fresh
    _fresh = True
    return NULL


def counting() -> bool:
    """Whether :func:`count` records here: under a profiler, in the
    forward phase."""
    return _profiling() and _graph_task() == -1


def count(name: str, value) -> None:
    """Add ``value`` (a number or a device tensor) to counter ``name``
    of the current window, where :func:`counting` holds."""
    if not counting():
        return
    c = _current().counters
    c[name] = c[name] + value if name in c else value


def record() -> Record:
    """The latest profiled window's occurrences and counter totals (an
    empty record where no window ran).  Synchronises the card where the
    window recorded device events; the next span under a profiler opens
    a new window."""
    global _fresh
    _fresh = True
    w = _window
    if w is None:
        return Record([], {})
    if w.result is None:
        done = sorted((o for o in w.spans if o.h1 is not None
                       and o.seq is not None), key=lambda o: o.seq)
        timed = [o for o in done if o.e0 is not None]
        if timed:
            torch.cuda.synchronize()
        h0 = done[0].h0 if done else 0
        e0 = timed[0].e0 if timed else None
        spans = [Occurrence(
            o.name, o.phase, (o.h0 - h0) * 1e-9, (o.h1 - h0) * 1e-9,
            None if o.e0 is None else e0.elapsed_time(o.e0),
            None if o.e1 is None else e0.elapsed_time(o.e1))
            for o in done]
        counters = {k: v.item() if isinstance(v, torch.Tensor) else v
                    for k, v in w.counters.items()}
        w.result = Record(spans, counters)
    return w.result
