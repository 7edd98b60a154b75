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

``current_tp`` is the mesh axis named ``"model"`` inside a rules context
that maps logical axes onto it: the tensor-parallel axis the model's
blocks split their heads, ffn, experts, vocab and rnn channels over.

``use(tree, r)`` is where the model takes the parameters of one unit
(the embedding, the final norm, the unembedding, one repeat ``r`` of a
scanned layer group): the tree itself (its repeat ``r``) outside an
fsdp step, and the unit made whole just in time inside one
(``param_gather``, :mod:`~repro_torch.parallelism.fsdp`).
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def axis_rules(rules: dict, mesh, sizes: Optional[Dict[str, int]] = None):
    """rules: {logical_axis_name: mesh_axis | tuple[mesh_axis] | None};
    mesh: a :class:`~repro_torch.parallelism.dist.Mesh`; sizes: the
    global size of each logical axis the model cuts in place."""
    prev = (current_rules(), current_mesh(), _current_sizes())
    _state.rules, _state.mesh, _state.sizes = rules, mesh, sizes
    try:
        yield
    finally:
        _state.rules, _state.mesh, _state.sizes = prev


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


def current_tp():
    """The tensor-parallel mesh axis (an ``Axis``) when the active rules
    shard anything over it, else None."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None or TP_AXIS not in mesh \
            or TP_AXIS not in rules.values():
        return None
    return mesh.axis(TP_AXIS)


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
        if isinstance(m, tuple):
            raise NotImplementedError(f"{a!r} over several mesh axes {m}")
        ax = mesh.axis(m)
        if x.shape[dim] == sizes[a]:
            x = C.split(x, dim, ax)
        elif x.shape[dim] * ax.size != sizes[a]:
            raise ValueError(f"dim {dim} ({a!r}) holds {x.shape[dim]} of "
                             f"{sizes[a]} over {ax.size} ranks")
    return x
