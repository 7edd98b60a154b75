"""Production meshes and logical->mesh sharding rules for the dry run,
the JAX package's ``launch/mesh.py`` without devices.

``make_production_mesh`` gives the 256-rank single-pod (16x16 data x
model) or 512-rank two-pod (2x16x16 pod x data x model) mesh as a
``Plan``-style ``mesh_axes`` tuple: the port runs one process a device,
so a mesh is its axes and sizes, and a rank's process groups are made
from them (``parallelism.dist.Mesh``).  Every function that takes a
``mesh`` takes such a tuple.

``cache_shardings`` gives per-dim placement tuples (a mesh axis, a tuple
of axes or None per dim) where the reference gives ``NamedSharding``s.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..models.config import InputShape, ModelConfig
from ..models.params import tree_leaves_with_paths, tree_map_with_path
from ..models.transformer import decode_state_spec, model_spec


def make_production_mesh(*, multi_pod: bool = False
                         ) -> Tuple[Tuple[str, int], ...]:
    if multi_pod:
        return (("pod", 2), ("data", 16), ("model", 16))
    return (("data", 16), ("model", 16))


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``mesh_axes`` tuple, in mesh order."""
    return dict(mesh)


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _axis_sizes(spec_tree, logical: str):
    """All dim sizes that carry a given logical axis name in the model."""
    sizes = set()
    for _, leaf in tree_leaves_with_paths(spec_tree):
        for dim, ax in zip(leaf.shape, leaf.axes):
            if ax == logical:
                sizes.add(dim)
    return sizes


def production_param_rules(cfg: ModelConfig, mesh,
                           multi_pod: bool) -> Dict[str, Optional[str]]:
    """2-D sharding: FSDP ("embed" over data) x TP ("heads"/"ffn"/
    "experts"/"vocab"/"rnn" over model), filtered by divisibility of
    every tensor dim that carries the logical axis.  Params are
    replicated across pods (pure data parallelism on the pod axis)."""
    spec_tree = model_spec(cfg)
    sizes = mesh_sizes(mesh)
    want = [("vocab", "model"), ("embed", "data"), ("heads", "model"),
            ("kv_heads", "model"), ("ffn", "model"), ("experts", "model"),
            ("rnn", "model")]
    rules: Dict[str, Optional[str]] = {}
    for logical, mesh_ax in want:
        n = sizes[mesh_ax]
        occ = _axis_sizes(spec_tree, logical)
        if occ and all(s % n == 0 for s in occ):
            rules[logical] = mesh_ax
    return rules


def activation_rules(cfg: ModelConfig, shape: InputShape,
                     multi_pod: bool) -> Dict[str, Optional[str]]:
    bax = batch_axes(multi_pod)
    total_b = 32 if multi_pod else 16
    return {
        "batch": bax if shape.global_batch % total_b == 0 else None,
        "seq": None,
        "vocab": "model" if cfg.vocab_size % 16 == 0 else None,
        "experts": ("model" if cfg.is_moe and
                    cfg.moe.num_experts % 16 == 0 else None),
    }


def cache_shardings(cfg: ModelConfig, shape: InputShape, mesh,
                    multi_pod: bool, dtype=None, policy: str = "heads"):
    """Placements for the decode state (KV caches / recurrent states),
    and the state's spec (meta tensors).

    Policy (baseline): batch over (pod,)data when divisible; for the
    KV cache prefer kv_heads -> model, then head_dim -> model, then the
    sequence dim -> model; long_500k (batch=1) shards the sequence dim
    over data.  Recurrent states shard their largest feature dim over
    model when divisible."""
    dtype = dtype or torch.bfloat16
    b, L = shape.global_batch, shape.seq_len
    spec = decode_state_spec(cfg, b, L, dtype)
    sizes = mesh_sizes(mesh)
    msize, dsize = sizes["model"], sizes["data"]
    total_b = math.prod(sizes[a] for a in batch_axes(multi_pod))
    bax = batch_axes(multi_pod) if b % total_b == 0 else None
    long_ctx = b == 1

    def leaf(path, s):
        name = path[-1]
        shp = tuple(s.shape)
        entries = [None] * len(shp)
        if name == "pos":
            return ()
        if name in ("k", "v"):
            off = len(shp) - 4           # stacked layer dim(s) lead
            if bax:
                entries[off] = bax
            if long_ctx and shp[off + 1] % dsize == 0:
                entries[off + 1] = "data"
            if policy == "seq" and shp[off + 1] % (
                    (dsize if long_ctx else 1) * msize) == 0:
                # sequence-sharded cache: decode attention reduces over
                # the sharded L dim (small score all-reduce) and the
                # append touches one shard -- no cache all-gather
                entries[off + 1] = (("data", "model") if long_ctx
                                    else "model")
            elif shp[off + 2] % msize == 0:
                entries[off + 2] = "model"          # kv heads
            elif shp[off + 3] % msize == 0:
                entries[off + 3] = "model"          # head_dim
            elif shp[off + 1] % (dsize * msize if long_ctx else msize) == 0:
                if long_ctx:
                    entries[off + 1] = ("data", "model")
                else:
                    entries[off + 1] = "model"      # sequence dim
            return tuple(entries)
        # recurrent states: (layers?, B, features...)
        # find batch dim: first dim equal to b after stacked dims
        off = 0
        for i, d in enumerate(shp):
            if d == b:
                off = i
                break
        if bax and shp[off] == b:
            entries[off] = bax
        # largest feature dim divisible by model size
        feat = [(d, i) for i, d in enumerate(shp) if i > off]
        feat.sort(reverse=True)
        for d, i in feat:
            if d % msize == 0:
                entries[i] = "model"
                break
        return tuple(entries)

    return tree_map_with_path(leaf, spec), spec
