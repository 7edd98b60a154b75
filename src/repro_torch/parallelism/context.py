"""Logical-axis partitioning context, the JAX package's
``parallelism/context.py`` for process groups.

Model code annotates activations with *logical* axis names via
``shard(x, "batch", "seq", None)``.  The parallelism layer installs a
rules mapping (logical axis -> mesh axis or None) with ``axis_rules``;
outside any rules context the calls are no-ops, so model code stays
mesh-agnostic.

``spec_for`` gives per-dim placements (a tuple with a mesh axis name or
None per dim) where the reference gives a ``PartitionSpec``.  Each rank
runs the model on its local tensors, so ``shard`` is where a tensor
that the rank holds whole along a dim that the rules shard is cut to
the rank's part (:func:`~repro_torch.parallelism.collectives.split`:
backward all-gather).  A dim mapped to the plan's batch axis was cut by
``BuiltJob.place_batch`` before the model ran, and a dim that already
holds the rank's part stays as it is; ``axis_rules``' ``sizes`` (each
logical axis's global size) tell the two apart.

``tp_for(logical)`` is the mesh axis named ``"model"`` inside a rules
context that maps the logical axis onto it: the tensor-parallel axis a
block splits its heads, ffn columns, experts, vocab rows or rnn
channels over.  A tuple of mesh axes (``("pod", "data")``) is one axis
over their product (``dist.Mesh``).

``use(tree, r)`` is where the model takes the parameters of one unit
(the embedding, the final norm, the unembedding, one repeat ``r`` of a
scanned layer group): the tree itself (its repeat ``r``), or, under
``param_gather`` (an fsdp step; a rules plan's step or prefill), the
unit made whole just in time along the dims cut over an axis other than
``"model"`` (:mod:`~repro_torch.parallelism.fsdp`).

``contract_for(logical)`` is the mesh axis a decode step contracts over
in place of gathering the weights: where the rules leave the batch
whole (a decode at B 1, the optimized preset's MoE decode), every rank
runs the same rows, so a weight cut on "embed" over data stays where it
lies and the projections split their contraction over that axis
(``models.layers.embed_in`` / ``embed_out``), as GSPMD partitions the
reference's decode; ``BuiltJob.running(params, layout)`` turns it on.

``state_layout`` holds the per-dim placements of a decode state's
leaves (``launch.mesh.cache_shardings``) while a rules plan decodes:
each leaf is the rank's part under its placement, and ``placed`` turns
a placement into the rank's :class:`~repro_torch.parallelism.dist.Axis`
of each dim (None where the dim is whole).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Optional, Sequence, Tuple

from ..models.params import tree_map
from . import collectives as C

_state = threading.local()

TP_AXIS = "model"


def current_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


def _current_sizes() -> Dict[str, int]:
    return getattr(_state, "sizes", None) or {}


def _in_place() -> bool:
    return getattr(_state, "in_place", False)


@contextlib.contextmanager
def axis_rules(rules: dict, mesh, sizes: Optional[Dict[str, int]] = None,
               in_place: bool = False):
    """rules: {logical_axis_name: mesh_axis | tuple[mesh_axis] | None};
    mesh: a :class:`~repro_torch.parallelism.dist.Mesh`; sizes: the
    global size of each logical axis the model cuts in place; in_place:
    a decode step that keeps the weights where they lie where the rules
    leave the batch whole (:func:`contract_for`)."""
    prev = (current_rules(), current_mesh(), _current_sizes(), _in_place())
    _state.rules, _state.mesh, _state.sizes, _state.in_place = \
        rules, mesh, sizes, in_place
    try:
        yield
    finally:
        _state.rules, _state.mesh, _state.sizes, _state.in_place = prev


@contextlib.contextmanager
def state_layout(layout):
    """The placements of the decode state's leaves, a tree beside the
    state (``launch.mesh.cache_shardings``' first tree; None: every leaf
    whole, or cut as the rules cut the block's weights)."""
    prev = current_layout()
    _state.layout = layout
    try:
        yield
    finally:
        _state.layout = prev


def current_layout():
    return getattr(_state, "layout", None)


def placed(placement) -> Tuple:
    """The rank's axis of each dim of a placement (a mesh axis, a tuple
    of axes or None per dim) under the active mesh: None where the dim
    is whole, and where its axes hold one rank."""
    mesh = current_mesh()
    out = []
    for m in placement:
        ax = mesh.axis(m) if m is not None else None
        out.append(ax if ax is not None and ax.size > 1 else None)
    return tuple(out)


def bound_rules():
    """A context that enters the axis rules in force now: a remat
    recompute reruns a block in the backward, which autograd runs on a
    thread of its own for a CUDA device, where this thread's rules are
    not set."""
    return functools.partial(axis_rules, current_rules(), current_mesh(),
                             _current_sizes(), _in_place())


def spec_for(axes: Sequence[Optional[str]], rules=None) -> Tuple:
    """Per-dim placements of a tensor whose dims carry ``axes``: the mesh
    axis (or tuple of axes) that shards each dim, or None."""
    rules = rules if rules is not None else (current_rules() or {})
    entries = []
    used = set()
    for a in axes:
        m = rules.get(a) if a is not None else None
        # one mesh axis may shard only one tensor dim
        if m is not None:
            key = tuple(m) if isinstance(m, (list, tuple)) else (m,)
            if any(k in used for k in key):
                m = None
            else:
                used.update(key)
        entries.append(tuple(m) if isinstance(m, list) else m)
    return tuple(entries)


@contextlib.contextmanager
def param_gather(gather):
    """Route :func:`use` through ``gather(tree, r)`` (an
    :class:`~repro_torch.parallelism.fsdp.ParamGather`)."""
    prev = getattr(_state, "gather", None)
    _state.gather = gather
    try:
        yield
    finally:
        _state.gather = prev


def use(tree, r: Optional[int] = None):
    """The parameters ``tree`` whole, as the model computes with them;
    ``r`` picks repeat ``r`` of a scanned group's stacked leaves."""
    return bound_use()(tree, r)


def bound_use():
    """:func:`use` bound to the gatherer in force now: a remat recompute
    calls it in the backward, after ``param_gather`` has ended."""
    gather = getattr(_state, "gather", None)
    if gather is not None:
        return gather
    return lambda tree, r=None: tree if r is None else \
        tree_map(lambda t: t[r], tree)


def tp_for(logical: str):
    """The tensor-parallel mesh axis (an ``Axis``) when the active rules
    shard the logical axis ``logical`` over it and it has more than one
    rank, else None: the model splits a block's work by heads, ffn
    columns, experts, vocab rows or rnn channels only where the rules
    cut its weights so."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None or TP_AXIS not in mesh \
            or rules.get(logical) != TP_AXIS:
        return None
    ax = mesh.axis(TP_AXIS)
    return ax if ax.size > 1 else None


def contract_for(logical: str):
    """The mesh axis (an ``Axis``) that the rules cut ``logical`` over,
    where a decode step keeps the weights in place (``axis_rules``'
    ``in_place``) under rules whose batch is None, and that axis is not
    the tensor-parallel one and has more than one rank; else None.  A
    weight cut on ``logical`` over it is then the rank's part as it
    lies: a projection over that dim contracts over the rank's slice of
    it and all-reduces the partial sums, one that writes it all-gathers
    the rank's slice."""
    rules, mesh = current_rules(), current_mesh()
    if not _in_place() or rules is None or mesh is None \
            or rules.get("batch") is not None:
        return None
    m = rules.get(logical)
    if m is None or m == TP_AXIS:
        return None
    ax = mesh.axis(m)
    return ax if ax.size > 1 else None


def shard(x, *axes):
    """Annotate activation x with logical axes (no-op without rules):
    a dim that the rules shard and that x holds whole is cut to the
    rank's part."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return x
    sizes = _current_sizes()
    for dim, (a, m) in enumerate(zip(axes, spec_for(axes, rules))):
        if m is None or a not in sizes:
            continue
        ax = mesh.axis(m)
        if x.shape[dim] == sizes[a]:
            x = C.split(x, dim, ax)
        elif x.shape[dim] * ax.size != sizes[a]:
            raise ValueError(f"dim {dim} ({a!r}) holds {x.shape[dim]} of "
                             f"{sizes[a]} over {ax.size} ranks")
    return x
