"""Parameter-spec system: single source of truth for shapes and init.

Modules define a tree (nested dicts and lists) of ``P`` specs;
``init_params`` materializes tensors with the same rules as the JAX
package (``_materialize``), drawn from a seeded ``torch.Generator``.
Torch cannot reproduce ``jax.random`` bits, so weights are carried
across packages as numpy arrays keyed by their slash-joined tree path
(``groups/0/pos0_swa/mixer/wq``), the keys of the checkpoint store.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class P:
    """Spec for one parameter tensor."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == ndim
    init: str = "normal"              # normal | zeros | ones | embed | const
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} mismatch")


def is_spec(x) -> bool:
    return isinstance(x, P)


def tree_leaves_with_paths(tree, prefix=()):
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted, lists
    by index.  A leaf is anything that is not a dict, list or tuple."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, prefix=()):
    """``tree_map`` whose ``fn`` also gets the leaf's path (a tuple of
    str keys, as ``tree_leaves_with_paths`` gives it)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _materialize(spec: P, gen: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "const":
        return torch.full(spec.shape, spec.scale, dtype=dtype, device=device)
    if spec.init in ("normal", "embed"):
        # same fan-in rule as the JAX package: shape[-2] (for the
        # (d, heads, head_dim) projections that is the head count)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / np.sqrt(max(fan_in, 1))
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)
    raise ValueError(f"unknown init {spec.init}")


def init_params(spec_tree, seed: int = 0, dtype=torch.float32,
                device="cuda"):
    """Materialize ``spec_tree`` on ``device`` from one generator seeded
    with ``seed``, drawing leaves in flatten order."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_map(lambda s: _materialize(s, gen, dtype, dev)
                    if is_spec(s) else s, spec_tree)


def param_count(spec_tree) -> int:
    return int(sum(int(np.prod(s.shape))
                   for _, s in tree_leaves_with_paths(spec_tree)))


def stack_specs(spec_tree, n: int, axis_name: Optional[str] = "layers"):
    """Add a leading 'stacked layers' dim of size n to every spec
    (params for a group of n pattern-repeats)."""
    return tree_map(
        lambda s: P((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale),
        spec_tree)


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """Flat {path: array}; bf16 and other non-numpy types go to float32,
    as the checkpoint store does."""
    out = {}
    for path, t in tree_leaves_with_paths(params):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out["/".join(path)] = t.numpy()
    return out


def params_from_numpy(flat: Dict[str, np.ndarray], dtype=None,
                      device="cuda"):
    """Inverse of ``params_to_numpy``: rebuild the nested tree from
    slash-joined paths.  Numeric path parts index lists (``groups/0``).
    ``dtype`` casts floating leaves (None keeps each array's own)."""
    dev = resolve_device(device)
    root: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        t = torch.from_numpy(np.array(arr))   # a private, writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        node[parts[-1]] = t.to(dev)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
