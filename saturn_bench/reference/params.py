"""A cell's weights from its seed, in the layout the program keeps them.

The tree is the decoder's: ``embed`` (V, d), ``final_norm`` (d,),
``unembed`` (d, V) unless tied, and ``groups``: one group for the whole
repeats of the block pattern, each leaf stacked over the repeats, and
one unstacked group for a remainder.  A block has ``mixer`` (norm, wq,
wk, wv, wo) and ``ffn`` (norm and wi_gate, wi_up, wo, or the MoE FFN's
norm, router and expert slabs).

The weights are the benchmark's input, handed alike to the program and
to the reference: one ``torch.Generator`` on the device seeded with the
seed, one normal draw in float32 a matrix with the standard deviation
of the source's ``initializer_range``, norm scales ones (no draw).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]   # path, shape, "normal" | "ones"


def layer_groups(cfg: dict) -> List[Tuple[bool, List[str], int]]:
    """[(stacked, kinds, repeats)]: the whole repeats of the block
    pattern, then the remainder unrolled."""
    pattern = list(cfg["block_pattern"])
    n_full, rem = divmod(cfg["num_layers"], len(pattern))
    groups = []
    if n_full:
        groups.append((True, pattern, n_full))
    if rem:
        groups.append((False, pattern[:rem], 1))
    return groups


def _block(cfg: dict, kind: str) -> Dict[str, Dict[str, tuple]]:
    d, h, kv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or d // h
    if kind not in ("attn", "swa"):
        raise NotImplementedError(f"block kind {kind!r}")
    mixer = {"wq": ((d, h, hd), "normal"), "wk": ((d, kv, hd), "normal"),
             "wv": ((d, kv, hd), "normal"), "wo": ((h, hd, d), "normal"),
             "norm": ((d,), "ones")}
    moe = cfg.get("moe")
    if moe:
        e, f = moe["num_experts"], moe["d_ff_expert"]
        ffn = {"norm": ((d,), "ones"), "router": ((d, e), "normal"),
               "wi_gate": ((e, d, f), "normal"),
               "wi_up": ((e, d, f), "normal"), "wo": ((e, f, d), "normal")}
    else:
        f = cfg["d_ff"]
        ffn = {"wi_gate": ((d, f), "normal"), "wi_up": ((d, f), "normal"),
               "wo": ((f, d), "normal"), "norm": ((d,), "ones")}
    return {"mixer": mixer, "ffn": ffn}


def leaves(cfg: dict) -> List[Leaf]:
    """Every leaf in draw order."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    out: List[Leaf] = [("embed", (v, d), "normal"),
                       ("final_norm", (d,), "ones")]
    if not cfg.get("tie_embeddings", True):
        out.append(("unembed", (d, v), "normal"))
    for gi, (stacked, kinds, n) in enumerate(layer_groups(cfg)):
        for i, kind in enumerate(kinds):
            for part, named in _block(cfg, kind).items():
                for name, (shape, init) in named.items():
                    if stacked:
                        shape = (n,) + shape
                    out.append((f"groups/{gi}/pos{i}_{kind}/{part}/{name}",
                                shape, init))
    return out


def iter_init(cfg: dict, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, float32 tensor) of every leaf in draw order, one at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    std = cfg["initializer_range"]
    for path, shape, init in leaves(cfg):
        if init == "ones":
            yield path, torch.ones(shape, dtype=torch.float32, device=device)
        else:
            yield path, torch.randn(shape, generator=gen, dtype=torch.float32,
                                    device=device).mul_(std)


def init(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return dict(iter_init(cfg, seed, device))


def nest(flat: Dict[str, torch.Tensor]):
    """The tree of slash-joined paths: dicts, and lists where the keys
    are indices (``groups/0``)."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)
