"""Per-dim placements for parameters and optimizer state from a Plan,
the JAX package's ``parallelism/shardings.py``, and the cut of one
rank's part out of a full tensor (``BuiltJob.full_state`` gathers the
parts back, a leaf at a time).

A placement is a tuple with one entry per dim: the mesh axis (or tuple
of axes, one axis over their product) that shards the dim, or None;
several dims may be cut, each over its own axes.  Each rank holds the
contiguous ``1/size`` slice of a sharded dim at its index along that
axis (:mod:`~repro_torch.parallelism.collectives`), as the reference's
mesh lays it out; a leaf whose placement shards no dim is replicated.
Placements are tuples, so a tree of them is only ever walked beside a
tree of tensors or specs (``tree_map(fn, tensors, placements)``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..models.params import P, tree_map
from . import collectives as C
from .base import Plan, largest_divisible_axis
from .context import spec_for


def param_pspec(spec: P, plan: Plan) -> Tuple:
    """Placement of one parameter under the plan's policy.  A dim placed
    on an axis (or tuple of axes) of one rank is not cut: its entry is
    None."""
    none = (None,) * len(spec.shape)
    if plan.param_policy == "replicate":
        return none
    if plan.param_policy == "fsdp":
        n = dict(plan.mesh_axes)["data"]
        idx = largest_divisible_axis(spec.shape, n)
        if idx is None:
            return none
        ps = tuple("data" if i == idx else None
                   for i in range(len(spec.shape)))
    elif plan.param_policy == "rules":
        ps = spec_for(spec.axes, plan.rules)
    elif plan.param_policy == "stage":
        # stacked-layer ("layers") axis sharded over the stage axis
        ps = tuple("stage" if a == "layers" else None for a in spec.axes)
    else:
        raise ValueError(plan.param_policy)
    sizes = dict(plan.mesh_axes)
    return tuple(m if m is not None and math.prod(
        sizes[a] for a in axis_names(m)) > 1 else None for m in ps)


def param_shardings(spec_tree, plan: Plan):
    return tree_map(lambda s: param_pspec(s, plan), spec_tree)


def param_shardings_from_rules(spec_tree, rules: Dict[str, Optional[str]]):
    """Production-mesh path: map logical param axes through ``rules``."""
    return tree_map(lambda s: spec_for(s.axes, rules), spec_tree)


def opt_state_shardings(spec_tree, plan_or_rules):
    """mu/nu mirror param placements; step is replicated."""
    if isinstance(plan_or_rules, Plan):
        ps = param_shardings(spec_tree, plan_or_rules)
    else:
        ps = param_shardings_from_rules(spec_tree, plan_or_rules)
    return {"mu": ps, "nu": ps, "step": ()}


def axis_names(m) -> Tuple[str, ...]:
    """The mesh axes of a placement entry (one name or a tuple)."""
    return tuple(m) if isinstance(m, (tuple, list)) else (m,)


def placement_leaves(layout, prefix=()):
    """(path, placement) of every placement in a tree of them (dicts and
    lists; a tuple is a placement), in ``tree_leaves_with_paths``
    order."""
    if isinstance(layout, dict):
        for k in sorted(layout):
            yield from placement_leaves(layout[k], prefix + (str(k),))
    elif isinstance(layout, list):
        for i, v in enumerate(layout):
            yield from placement_leaves(v, prefix + (str(i),))
    else:
        yield prefix, layout


def cuts(pspec: Tuple) -> List[Tuple[int, object]]:
    """(dim, mesh axis or tuple of axes) of every dim the placement cuts."""
    return [(i, m) for i, m in enumerate(pspec) if m is not None]


def local_shape(shape, pspec: Tuple, sizes: Dict[str, int]) -> Tuple:
    """The shape of a rank's part of a tensor of ``shape``."""
    out = list(shape)
    for d, m in cuts(pspec):
        out[d] = C.part(out[d], math.prod(sizes[a] for a in axis_names(m)))
    return tuple(out)


def cut(full: torch.Tensor, pspec: Tuple, mesh) -> torch.Tensor:
    """This rank's part of ``full`` under ``pspec`` (a private copy)."""
    for dim, m in cuts(pspec):
        full = C.local_slice(full, dim, mesh.axis(m))
    return full.clone()


def cut_tree(tree, pspecs, mesh):
    return tree_map(lambda t, ps: cut(t, ps, mesh), tree, pspecs)
