"""Composable decoder covering the ported architecture families: the
attention families (``attn`` / ``swa`` mixers with a dense FFN) and
xLSTM (``mlstm`` / ``slstm`` mixers, no FFN).

Layers follow ``cfg.block_pattern``; repeats of the pattern run as a
Python loop over params stacked along a leading dim (the JAX package's
``lax.scan``), with an unrolled remainder, so parameter and state trees
keep the JAX package's layout.  Supports the full-sequence forward,
serving prefill (last-position logits plus a decode-ready state: KV
caches or recurrent states) and single-token decode against that state.

``opts=None`` means ``kernel_opts(<device of the params>)``: on CUDA the
full-sequence attention, mLSTM and sLSTM run the hand-written kernels.
An explicit ``opts={}`` asks for the plain path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..device import resolve_device
from ..kernels.ops import kernel_opts
from .config import ATTN, MLSTM, RECURRENT, RGLRU, SLSTM, SWA, ModelConfig
from .layers import (attention, attention_spec, attn_cache_spec, ffn,
                     ffn_spec, rmsnorm, rmsnorm_spec)
from .params import P, init_params, stack_specs, tree_map, tree_map_with_path
from .recurrent import (mlstm_block, mlstm_block_spec, mlstm_state_spec,
                        slstm_block, slstm_block_spec, slstm_state_spec)

_NOT_PORTED = {
    RGLRU: "the RG-LRU block is not ported yet (ROADMAP A9)",
}


def _check_kind(cfg: ModelConfig, kind: str):
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED[kind]}")
    if kind not in (ATTN, SWA, MLSTM, SLSTM):
        raise ValueError(kind)
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported yet (ROADMAP A8)")


# ------------------------------------------------------------------ specs

_MIXER_SPECS = {ATTN: attention_spec, SWA: attention_spec,
                MLSTM: mlstm_block_spec, SLSTM: slstm_block_spec}


def block_spec(cfg: ModelConfig, kind: str):
    _check_kind(cfg, kind)
    spec: Dict[str, Any] = {"mixer": _MIXER_SPECS[kind](cfg)}
    if cfg.d_ff:
        spec["ffn"] = ffn_spec(cfg)
    return spec


def model_spec(cfg: ModelConfig):
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": P((cfg.vocab_size, d), ("vocab", "embed"), init="embed"),
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = P((d, cfg.vocab_size), ("embed", "vocab"))
    groups = []
    for mode, pattern, n in cfg.layer_plan():
        g = {}
        for i, kind in enumerate(pattern):
            bs = block_spec(cfg, kind)
            g[f"pos{i}_{kind}"] = stack_specs(bs, n) if mode == "scan" else bs
        groups.append(g)
    spec["groups"] = groups
    return spec


def init_model(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
               device="cuda"):
    return init_params(model_spec(cfg), seed, dtype, device)


# ----------------------------------------------------------------- caches

def _block_cache_spec(cfg: ModelConfig, kind: str, batch: int, length: int,
                      dtype):
    _check_kind(cfg, kind)
    if kind == MLSTM:
        return mlstm_state_spec(cfg, batch, dtype)
    if kind == SLSTM:
        return slstm_state_spec(cfg, batch, dtype)
    return attn_cache_spec(cfg, batch, length, dtype)


def decode_state_spec(cfg: ModelConfig, batch: int, length: int,
                      dtype=torch.bfloat16):
    """Decode state for the whole stack as meta tensors (shape and dtype,
    no storage); scanned groups carry a leading layer dim."""
    groups = []
    for mode, pattern, n in cfg.layer_plan():
        g = {}
        for i, kind in enumerate(pattern):
            c = _block_cache_spec(cfg, kind, batch, length, dtype)
            if mode == "scan":
                c = tree_map(lambda s: torch.empty(
                    (n,) + tuple(s.shape), dtype=s.dtype, device="meta"), c)
            g[f"pos{i}_{kind}"] = c
        groups.append(g)
    return {"layers": groups,
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def state_batch_axes(cfg: ModelConfig):
    """Batch axis of every decode-state leaf (KV caches and recurrent
    states alike): 1 under a stacked (scan) group's layer dim, 0
    otherwise; ``pos`` is per-row at axis 0."""
    spec = decode_state_spec(cfg, 1, 1)
    groups = [tree_map(lambda _, ax=int(mode == "scan"): ax, g)
              for (mode, _, _), g in zip(cfg.layer_plan(), spec["layers"])]
    return {"layers": groups, "pos": 0}


def init_decode_state(cfg: ModelConfig, batch: int, length: int,
                      dtype=torch.bfloat16, per_row_pos: bool = False,
                      device="cuda"):
    """Zero-initialized decode state on ``device``, with the recurrent
    stabilizers (every leaf named ``m``) at -1e30.  per_row_pos=True
    gives ``pos`` shape (batch,): each slot tracks its own position."""
    dev = resolve_device(device)
    spec = decode_state_spec(cfg, batch, length, dtype)
    layers = tree_map_with_path(
        lambda path, s: torch.full(s.shape, -1e30 if path[-1] == "m" else 0,
                                   dtype=s.dtype, device=dev),
        spec["layers"])
    pos = torch.zeros((batch,) if per_row_pos else (), dtype=torch.int32,
                      device=dev)
    return {"layers": layers, "pos": pos}


# ---------------------------------------------------------------- forward

def _block_apply(p, x, *, kind, cfg: ModelConfig, cache=None, positions=None,
                 pos=None, opts=None, prefill=False):
    _check_kind(cfg, kind)
    opts = opts or {}
    h = rmsnorm(p["mixer"]["norm"], x, cfg.norm_eps)
    if kind == MLSTM:
        y, nc = mlstm_block(p["mixer"], h, cfg, state=cache,
                            parallel_fn=opts.get("mlstm_fn"),
                            return_state=prefill)
    elif kind == SLSTM:
        y, nc = slstm_block(p["mixer"], h, cfg, state=cache,
                            return_state=prefill,
                            slstm_fn=opts.get("slstm_fn"))
    else:
        window = cfg.window_size if kind == SWA else 0
        y, nc = attention(p["mixer"], h, cfg, window=window, cache=cache,
                          positions=positions, pos=pos,
                          attn_fn=opts.get("attn_fn"), return_cache=prefill)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in p:
        h2 = rmsnorm(p["ffn"]["norm"], x, cfg.norm_eps)
        x = x + ffn(p["ffn"], h2)
    return x, nc, aux


def _run_groups(params, cfg: ModelConfig, x, *, caches=None, positions=None,
                pos=None, opts=None, prefill=False):
    """Run all layer groups.  Returns (x, new_caches, aux).

    prefill=True: caches are None on input but every block *returns* its
    decode-ready state.  With caches (decode) an attention block writes
    into its slot of the (stacked) KV cache in place, so the input cache
    is returned as the new one; a recurrent block returns new state
    tensors, stacked here like the params."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_groups = []
    for gi, (mode, pattern, n) in enumerate(cfg.layer_plan()):
        gparams = params["groups"][gi]
        gcaches = caches[gi] if caches is not None else None
        reps = 1 if mode == "unroll" else n
        collected = {f"pos{i}_{kind}": [] for i, kind in enumerate(pattern)}
        for r in range(reps):
            at = (lambda t: t) if mode == "unroll" else (lambda t, r=r: t[r])
            for i, kind in enumerate(pattern):
                key = f"pos{i}_{kind}"
                c = tree_map(at, gcaches[key]) if gcaches is not None else None
                x, nc, a = _block_apply(
                    tree_map(at, gparams[key]), x, kind=kind, cfg=cfg,
                    cache=c, positions=positions, pos=pos, opts=opts,
                    prefill=prefill)
                aux_total = aux_total + a
                if prefill or (gcaches is not None and kind in RECURRENT):
                    collected[key].append(nc)
        if gcaches is None and not prefill:
            new_groups.append(None)
            continue
        new_g = {}
        for i, kind in enumerate(pattern):
            key = f"pos{i}_{kind}"
            if not collected[key]:           # KV cache, updated in place
                new_g[key] = gcaches[key]
            elif mode == "unroll":
                new_g[key] = collected[key][0]
            else:
                new_g[key] = {name: torch.stack([c[name]
                                                 for c in collected[key]])
                              for name in collected[key][0]}
        new_groups.append(new_g)
    return x, new_groups, aux_total


def _resolve_opts(params, opts):
    return kernel_opts(params["embed"].device) if opts is None else opts


def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """Token / frontend embedding.  batch keys: tokens (B,S) int and/or
    embeds (B,S,d) float (audio frames / vision patches, stubbed)."""
    parts = []
    if batch.get("embeds") is not None:
        parts.append(batch["embeds"].to(params["embed"].dtype))
    if batch.get("tokens") is not None:
        parts.append(params["embed"][batch["tokens"].long()])
    if not parts:
        raise ValueError("batch must contain tokens and/or embeds")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def unembed(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x, params["unembed"])


def forward(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            opts: Optional[dict] = None):
    """Full-sequence forward.  Returns (logits, aux_loss)."""
    opts = _resolve_opts(params, opts)
    x = embed_inputs(params, cfg, batch)
    x, _, aux = _run_groups(params, cfg, x, opts=opts)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, cfg, x), aux


def prefill_forward(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                    opts: Optional[dict] = None):
    """Serving prefill: full-sequence forward that returns ONLY the
    last-position logits plus a decode-ready state (KV caches of length
    seq) -- never materializes (B, S, vocab)."""
    opts = _resolve_opts(params, opts)
    x = embed_inputs(params, cfg, batch)
    s = x.shape[1]
    x, new_caches, _ = _run_groups(params, cfg, x, opts=opts, prefill=True)
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = unembed(params, cfg, x)
    return logits, {"layers": new_caches,
                    "pos": torch.tensor(s, dtype=torch.int32,
                                        device=x.device)}


def decode_step(params, cfg: ModelConfig, tokens, state, *,
                opts: Optional[dict] = None):
    """One decode step.  tokens: (B, 1) int; state from
    ``init_decode_state`` (its caches are updated in place).  Returns
    (logits (B,1,V), new_state)."""
    opts = _resolve_opts(params, opts)
    pos = state["pos"]
    x = params["embed"][tokens.long()]
    x, new_caches, _ = _run_groups(
        params, cfg, x, caches=state["layers"], pos=pos, opts=opts)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params, cfg, x)
    return logits, {"layers": new_caches, "pos": pos + 1}
