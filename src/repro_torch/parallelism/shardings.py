"""Per-dim placements for parameters and optimizer state from a Plan,
the JAX package's ``parallelism/shardings.py``, and the cut of one
rank's part out of a full tensor (``BuiltJob.full_state`` gathers the
parts back, in one flat all-gather).

A placement is a tuple with one entry per dim: the mesh axis that
shards the dim, or None.  Each rank holds the contiguous ``1/size``
slice of a sharded dim at its index along that axis
(:mod:`~repro_torch.parallelism.collectives`), as the reference's mesh
lays it out; a leaf whose placement shards no dim is replicated.
Placements are tuples, so a tree of them is only ever walked beside a
tree of tensors or specs (``tree_map(fn, tensors, placements)``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.params import P, tree_map
from . import collectives as C
from .base import Plan, largest_divisible_axis
from .context import spec_for


def param_pspec(spec: P, plan: Plan) -> Tuple:
    """Placement of one parameter under the plan's policy."""
    none = (None,) * len(spec.shape)
    if plan.param_policy == "replicate":
        return none
    if plan.param_policy == "fsdp":
        n = dict(plan.mesh_axes)["data"]
        idx = largest_divisible_axis(spec.shape, n)
        if idx is None:
            return none
        return tuple("data" if i == idx else None
                     for i in range(len(spec.shape)))
    if plan.param_policy == "rules":
        return spec_for(spec.axes, plan.rules)
    if plan.param_policy == "stage":
        # stacked-layer ("layers") axis sharded over the stage axis
        return tuple("stage" if a == "layers" else None for a in spec.axes)
    raise ValueError(plan.param_policy)


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


def sharded_dim(pspec: Tuple) -> Optional[Tuple[int, str]]:
    """(dim, mesh axis) of a placement that shards one dim, else None."""
    dims = [(i, m) for i, m in enumerate(pspec) if m is not None]
    if not dims:
        return None
    if len(dims) > 1 or isinstance(dims[0][1], tuple):
        raise NotImplementedError(
            f"placement {pspec}: the port shards a tensor over one mesh "
            "axis in one dim")
    return dims[0]


def cut(full: torch.Tensor, pspec: Tuple, mesh) -> torch.Tensor:
    """This rank's part of ``full`` under ``pspec`` (a private copy)."""
    sd = sharded_dim(pspec)
    if sd is None:
        return full.clone()
    dim, axis = sd
    return C.local_slice(full, dim, mesh.axis(axis)).clone()


def cut_tree(tree, pspecs, mesh):
    return tree_map(lambda t, ps: cut(t, ps, mesh), tree, pspecs)

