"""``scan``: the models' time loops, the port's counterpart of the
``jax.lax.scan`` calls in the JAX package's loops.

On tensors with data (CPU or CUDA) :func:`scan` is the plain Python loop,
op for op, followed by one ``torch.stack`` or ``torch.cat`` of the
per-trip outputs.

Under a loop-aware counter (the step analyzer's count on ``meta``
tensors, ``launch/step_analysis.py``, which registers itself through
:func:`counting`) a loop of n >= 5 trips runs four of them and has the
counter charge the other n - 4, as the JAX package's
``computation_multipliers`` multiplies a while body by its trip count.
The trips run are the ones that differ from the rest, and one of the
rest for each direction:

- the first trip, whose carry comes from outside the loop: autograd
  skips the products for a carry that needs no gradient;
- the second trip, whose forward stands for the middle trips': the
  counter records what it costs (flops, bytes written, collectives and
  the records by op) and the live bytes it leaves, and charges both
  n - 4 more times, each charged trip starting where the one before left
  the live bytes;
- trip n - 2, run after the charged ones (the carry passes them
  unchanged), whose backward stands for the middle trips': autograd's
  engine runs a graph's nodes in the reverse order of their creation, so
  the nodes of one trip run together, between those of the trip after
  it and those of the trip before.  Pre-hooks on the grad_fns of the
  trips' outputs delimit trip n - 2's backward, and the counter charges
  it n - 4 more times before trip 1's backward runs.  The second trip's
  backward is not one of the middle ones: it frees what the trips share
  (the gradient of the joined outputs, whose last slice it consumes);
- the last trip, whose outputs leave the loop: autograd skips the
  products for an output that gets no gradient.

Each storage the second trip's forward leaves alive carries the bytes of
its n - 4 charged counterparts.  Freed while a loop of the same name
runs (forward, or backward between its last trip's first node and its
first trip's first node), it is freed with its trip, and the charged
trips' share is in what the counter charged for their backward; freed
anywhere else (the list of the trips' outputs, a graph dropped whole) it
takes its counterparts with it.  So the live bytes, and their peak, are
the full replay's: the charged trips' peaks lie on a line through the
counted trip's, and where the live bytes grow from trip to trip the
counter adds the last one's.  A remat recompute runs the loop again and
is counted the same way.

The per-trip outputs are joined once, over all n trips (the charged ones
stand in by the second trip's output), by an autograd function whose
backward hands each run trip its slice of the gradient, as the plain
join's backward hands every trip a view of it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch

_LOCAL = threading.local()


def counter():
    """The loop-aware counter of this thread, or None."""
    return getattr(_LOCAL, "counter", None)


@contextlib.contextmanager
def counting(c):
    """Make ``c`` this thread's loop-aware counter inside the block:
    ``c.loop_begin()`` returns a token for one trip counted apart,
    ``c.loop_end(token, k, name, forward)`` adds that trip and charges
    it ``k`` more times, and ``c.loop_window(name, step)`` opens (+1)
    or closes (-1) a window in which loop ``name`` runs
    (``launch.step_analysis.StepCounter``)."""
    prev = counter()
    _LOCAL.counter = c
    try:
        yield
    finally:
        _LOCAL.counter = prev


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _join(ys: list, stack):
    """ys joined as the plain loop joins them: ``stack`` is ("stack",
    dim) or ("cat", dim); a tuple y is joined component by component."""
    if stack is None:
        return None
    how, dim = stack
    op = torch.stack if how == "stack" else torch.cat
    if isinstance(ys[0], tuple):
        return [op([y[i] for y in ys], dim) for i in range(len(ys[0]))]
    return op(ys, dim)


class _Join(torch.autograd.Function):
    """The join of n per-trip outputs of which trips 0, 1, n - 2 and
    n - 1 ran, the charged ones standing in by trip 1's; the backward
    hands the four their slices of the gradient."""

    @staticmethod
    def forward(ctx, how, dim, n, *run):
        ctx.how, ctx.dim, ctx.n = how, dim, n
        ctx.sizes = [y.shape[dim] for y in run]
        y0, y1, y2, yl = run
        return _join([y0, y1] + [y1] * (n - 4) + [y2, yl], (how, dim))

    @staticmethod
    def backward(ctx, g):
        need, dim, n = ctx.needs_input_grad[3:], ctx.dim, ctx.n
        if ctx.how == "stack":
            parts = [g.select(dim, i) if w else None
                     for i, w in zip((0, 1, n - 2, n - 1), need)]
        else:
            s0, s1, s2, sl = ctx.sizes
            end = g.shape[dim]
            spans = ((0, s0), (s0, s1), (end - sl - s2, s2), (end - sl, sl))
            parts = [g.narrow(dim, o, s) if w else None
                     for (o, s), w in zip(spans, need)]
        return (None, None, None, *parts)


def _grad_fns(carry, y, before) -> list:
    """The distinct grad_fns of a trip's outputs (``carry`` and ``y``)
    that are not among ``before``, the grad_fns of its inputs (an input
    passed through).  Only nodes are kept: holding the tensors would
    keep them alive past the point where the loop frees them."""
    got = []
    for t in _tensors((carry, y)):
        f = t.grad_fn
        if f is None or any(f is g for g in before) \
                or any(f is g for g in got):
            continue
        got.append(f)
    return got


def _inputs(carry) -> list:
    return [t.grad_fn for t in _tensors(carry) if t.grad_fn is not None]


def _watch_backward(c, name: str, k: int, g0, g1, g2, gl) -> None:
    """Pre-hooks on the grad_fns of trips 0, 1, n - 2 and n - 1's
    outputs (``g0``, ``g1``, ``g2``, ``gl``): the loop's window opens
    when the last trip's backward starts and closes when the first
    trip's does (or when the backward ends); trip n - 2's backward is
    counted apart from its first node to trip 1's first node, and
    charged ``k`` more times there."""
    state = {"open": False, "token": None, "counted": False, "hooks": []}

    def close():
        for h in state["hooks"]:
            h.remove()
        state["hooks"] = []
        if state["open"]:
            state["open"] = False
            c.loop_window(name, -1)

    def at_end():
        if state["token"] is not None:
            raise RuntimeError(
                f"the backward of loop {name!r} ran trip n - 2 but not "
                f"trip 1: its charge cannot be closed")
        close()

    def open_(_):
        if not state["open"] and not state["counted"]:
            state["open"] = True
            c.loop_window(name, 1)
            torch.autograd.Variable._execution_engine.queue_callback(at_end)

    def begin(_):
        if state["token"] is None and not state["counted"]:
            open_(None)
            state["token"] = c.loop_begin()

    def charge(_):
        if state["token"] is not None:
            token, state["token"] = state["token"], None
            state["counted"] = True
            c.loop_end(token, k, name, False)

    for fns, hook in ((gl, open_), (g2, begin), (g1, charge),
                      (g0, lambda _: close())):
        for f in fns:
            state["hooks"].append(f.register_prehook(hook))


def scan(body: Callable, carry, n: int, *, name: str, reverse: bool = False,
         stack: Optional[Sequence] = None):
    """Run ``carry, y = body(t, carry)`` for t in 0 .. n-1 (n-1 .. 0 with
    ``reverse``); returns ``(carry, ys)``.  ``ys`` is None without
    ``stack``; with ``stack`` = ("stack", dim) or ("cat", dim) it is the
    y's joined that way (a tuple y, outside autograd: a list of its
    components joined).
    ``name`` names the loop to a loop-aware counter (see the module
    docstring), which runs trips 0, 1, n - 2 and n - 1 only."""
    ts = range(n - 1, -1, -1) if reverse else range(n)
    c = counter()
    if c is None or n < 5:
        ys = []
        for t in ts:
            carry, y = body(t, carry)
            ys.append(y)
        return carry, _join(ys, stack)
    k = n - 4
    ys = []
    c.loop_window(name, 1)
    try:
        before = _inputs(carry)
        carry, y = body(ts[0], carry)
        ys.append(y)
        g0 = _grad_fns(carry, y, before)
        before = _inputs(carry)
        token = c.loop_begin()
        try:
            carry, y = body(ts[1], carry)
        except BaseException:
            c.loop_end(token, 0, name, True)
            raise
        c.loop_end(token, k, name, True)
        ys += [y] * (1 + k)
        g1 = _grad_fns(carry, y, before)
        grads = []
        for t in ts[-2:]:
            before = _inputs(carry)
            carry, y = body(t, carry)
            ys.append(y)
            grads.append(_grad_fns(carry, y, before))
    finally:
        c.loop_window(name, -1)
    if g1:
        _watch_backward(c, name, k, g0, g1, *grads)
    if stack is not None and torch.is_grad_enabled() and any(
            t.requires_grad for t in _tensors(ys)):
        return carry, _Join.apply(*stack, n, ys[0], ys[1], ys[-2], ys[-1])
    return carry, _join(ys, stack)
