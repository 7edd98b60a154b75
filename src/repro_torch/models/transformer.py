"""Composable decoder covering the ported architecture families: the
attention families (``attn`` / ``swa`` mixers with a dense FFN), MoE
(``attn`` mixers with the Mixture-of-Experts FFN of ``moe.py``, whose
load-balance loss is the forward's aux), xLSTM (``mlstm`` / ``slstm``
mixers, no FFN) and RecurrentGemma (``rglru`` and ``swa`` mixers with a
dense FFN).

Layers follow ``cfg.block_pattern``; repeats of the pattern run as a
Python loop over params stacked along a leading dim (the JAX package's
``lax.scan``), with an unrolled remainder, so parameter and state trees
keep the JAX package's layout.  Supports the full-sequence forward,
serving prefill (last-position logits plus a decode-ready state: KV
caches or recurrent states) and single-token decode against that state.

The ``shard`` calls mark the JAX package's annotation sites (the
residual stream after each scanned repeat, the embedding, the logits);
outside a rules context they return their input.  Under tensor
parallelism the embedding and unembedding are split over the vocab:
each rank looks up and scores its vocab rows, and the loss is taken
over the ranks' logit shards (``train.steps``).  The model takes the
parameters of each unit through ``use`` (the embedding, the final norm,
the unembedding, a block of a layer group), where an fsdp step makes
them whole just in time.  A decode step that keeps the weights in place
(``parallelism.context.contract_for``) looks up and scores the rank's
slice of embed, and gathers or sums it over data
(``layers.embed_in`` / ``embed_out``).

``opts=None`` means ``kernel_opts(<device of the params>)``: on CUDA the
full-sequence attention, RG-LRU scan, mLSTM and sLSTM run the
hand-written kernels.
An explicit ``opts={}`` asks for the plain path, which training takes
(``train.steps.lm_loss``): the kernels have no backward.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels.ops import kernel_opts
from ..parallelism import collectives as C
from ..parallelism.context import (batch_axis, bound_rules, bound_use,
                                   current_layout, placed, shard, tp_for,
                                   use)
from .config import ATTN, MLSTM, RECURRENT, RGLRU, SLSTM, SWA, ModelConfig
from .layers import (attention, attention_spec, attn_cache_spec, embed_in,
                     embed_out, ffn, ffn_spec, rmsnorm, rmsnorm_spec)
from .moe import moe_ffn, moe_spec
from .params import P, init_params, stack_specs, tree_map, tree_map_with_path
from .recurrent import (mlstm_block, mlstm_block_spec, mlstm_state_spec,
                        rglru_block, rglru_block_spec, rglru_state_spec,
                        slstm_block, slstm_block_spec, slstm_state_spec)


def _check_kind(kind: str):
    if kind not in (ATTN, SWA, RGLRU, MLSTM, SLSTM):
        raise ValueError(kind)


# ------------------------------------------------------------------ specs

_MIXER_SPECS = {ATTN: attention_spec, SWA: attention_spec,
                RGLRU: rglru_block_spec, MLSTM: mlstm_block_spec,
                SLSTM: slstm_block_spec}


def block_spec(cfg: ModelConfig, kind: str):
    _check_kind(kind)
    spec: Dict[str, Any] = {"mixer": _MIXER_SPECS[kind](cfg)}
    if cfg.d_ff or cfg.is_moe:
        spec["ffn"] = moe_spec(cfg) if cfg.is_moe else ffn_spec(cfg)
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
    _check_kind(kind)
    if kind == RGLRU:
        return rglru_state_spec(cfg, batch, dtype)
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

def _state_rows(h, cache, place):
    """The axis that cuts a decode state's rows where ``h`` holds every
    row (the rules leave the batch whole and the state's placement cuts
    it), else None."""
    if place is None:
        return None
    name = sorted(place)[0]
    ax, n = place[name][0], cache[name].shape[0]
    if h.shape[0] == n:
        return None
    if ax is None or h.shape[0] != n * ax.size:
        raise NotImplementedError(
            f"{h.shape[0]} rows of activations against {n} rows of the "
            f"decode state cut over {ax}")
    return ax


def _block_apply(p, x, *, kind, cfg: ModelConfig, cache=None, positions=None,
                 pos=None, opts=None, prefill=False, place=None):
    """One block.  In decode, ``place`` gives the rank's axis of each dim
    of each state leaf (None: nothing cut); where the state's rows are
    cut and the activations' are not, the mixer projects every row, runs
    its attention or recurrence on the rank's rows and gathers them
    before its output projection (``rows``)."""
    _check_kind(kind)
    opts = opts or {}
    h = rmsnorm(p["mixer"]["norm"], x, cfg.norm_eps)
    rows = _state_rows(h, cache, place)
    if kind == RGLRU:
        y, nc = rglru_block(p["mixer"], h, cfg, state=cache,
                            scan_fn=opts.get("rglru_scan"),
                            return_state=prefill, place=place, rows=rows)
    elif kind == MLSTM:
        y, nc = mlstm_block(p["mixer"], h, cfg, state=cache,
                            parallel_fn=opts.get("mlstm_fn"),
                            return_state=prefill, place=place, rows=rows)
    elif kind == SLSTM:
        y, nc = slstm_block(p["mixer"], h, cfg, state=cache,
                            return_state=prefill,
                            slstm_fn=opts.get("slstm_fn"),
                            batched_grad=opts.get("slstm_batched_grad",
                                                  False), place=place,
                            rows=rows)
    else:
        window = cfg.window_size if kind == SWA else 0
        y, nc = attention(p["mixer"], h, cfg, window=window, cache=cache,
                          positions=positions, pos=pos,
                          attn_fn=opts.get("attn_fn"), return_cache=prefill,
                          place=None if place is None else place["k"],
                          rows=rows)
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in p:
        h2 = rmsnorm(p["ffn"]["norm"], x, cfg.norm_eps)
        if cfg.is_moe:
            y2, aux = moe_ffn(p["ffn"], h2, cfg)
        else:
            y2 = ffn(p["ffn"], h2)
        x = x + y2
    return x, nc, aux


def _block_place(layout, stacked: bool):
    """{leaf: the rank's axis of each dim of one layer's leaf} of a
    block's state ``layout`` (placements, with the layer dim first where
    ``stacked``); None where nothing is cut."""
    if layout is None:
        return None
    out = {}
    for name, pl in layout.items():
        if stacked:
            if pl[0] is not None:
                raise NotImplementedError(
                    f"a decode state cut on its layer dim ({name}: {pl})")
            pl = pl[1:]
        out[name] = placed(pl)
    return out if any(a is not None for v in out.values() for a in v) \
        else None


def _run_groups(params, cfg: ModelConfig, x, *, caches=None, positions=None,
                pos=None, opts=None, remat=False, prefill=False,
                layout=None):
    """Run all layer groups.  Returns (x, new_caches, aux).

    prefill=True: caches are None on input but every block *returns* its
    decode-ready state.  With caches (decode) an attention block writes
    into its slot of the (stacked) KV cache in place, so the input cache
    is returned as the new one; a recurrent block returns new state
    tensors, stacked here like the params.  ``layout``: the placements
    of the caches' leaves, where each is the rank's part (decode under a
    rules plan).

    remat=True recomputes activations in the backward pass at the JAX
    package's granularity: one repeat of the pattern in a scanned group,
    each block in an unrolled one."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_groups = []
    take, rules = bound_use(), bound_rules()
    for gi, (mode, pattern, n) in enumerate(cfg.layer_plan()):
        gparams = params["groups"][gi]
        gcaches = caches[gi] if caches is not None else None
        glayout = layout[gi] if layout is not None else None
        reps = 1 if mode == "unroll" else n
        keyed = [(f"pos{i}_{kind}", kind) for i, kind in enumerate(pattern)]
        units = [[k] for k in keyed] if mode == "unroll" else [keyed]
        collected = {key: [] for key, _ in keyed}
        for r in range(reps):
            at = (lambda t: t) if mode == "unroll" else (lambda t, r=r: t[r])
            rep = None if mode == "unroll" else r
            for unit in units:
                # bound now: a remat recompute calls run after the loop
                # has moved on to a later group, and in the backward
                def run(x_, unit=unit, at=at, rep=rep, gparams=gparams,
                        gcaches=gcaches, glayout=glayout, take=take):
                    ncs, aux_ = {}, 0.0
                    with rules():
                        for key, kind in unit:
                            c = (tree_map(at, gcaches[key])
                                 if gcaches is not None else None)
                            place = _block_place(
                                glayout and glayout[key], mode == "scan")
                            x_, ncs[key], a = _block_apply(
                                take(gparams[key], rep), x_, kind=kind,
                                cfg=cfg, cache=c, positions=positions,
                                pos=pos, opts=opts, prefill=prefill,
                                place=place)
                            aux_ = aux_ + a
                    return x_, ncs, aux_
                if remat:
                    x, ncs, a = checkpoint(run, x, use_reentrant=False)
                else:
                    x, ncs, a = run(x)
                if mode == "scan":
                    x = shard(x, "batch", "seq", None)
                aux_total = aux_total + a
                for key, kind in unit:
                    if prefill or (gcaches is not None and kind in RECURRENT):
                        collected[key].append(ncs[key])
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
        parts.append(_embed_tokens(use(params["embed"]), batch["tokens"]))
    if not parts:
        raise ValueError("batch must contain tokens and/or embeds")
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return shard(x, "batch", "seq", None)


def _embed_tokens(table, tokens):
    """Rows of ``table`` for ``tokens``; under tensor parallelism the
    rank holds a slice of the vocab, looks up the tokens that fall in
    it, and the ranks' rows are summed.  Where a decode step keeps the
    weights in place the table holds the rank's slice of embed, and the
    rows' slices are all-gathered after the sum."""
    tp = tp_for("vocab")
    if tp is None:
        return embed_out(table[tokens.long()])
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
    return embed_out(C.reduce_out(rows, tp))


def unembed(params, cfg: ModelConfig, x):
    tp = tp_for("vocab")
    if tp is not None:
        x = C.copy_in(x, tp)
    if cfg.tie_embeddings:
        eq, w = "bsd,vd->bsv", use(params["embed"])
    else:
        eq, w = "bsd,dv->bsv", use(params["unembed"])
    logits = embed_in(lambda x_, w_: torch.einsum(eq, x_, w_), x, w)[0]
    return shard(logits, "batch", "seq", "vocab")


def forward(params, cfg: ModelConfig, batch: Dict[str, Any], *,
            opts: Optional[dict] = None, remat: bool = False):
    """Full-sequence forward.  Returns (logits, aux_loss)."""
    opts = _resolve_opts(params, opts)
    x = embed_inputs(params, cfg, batch)
    x, _, aux = _run_groups(params, cfg, x, opts=opts, remat=remat)
    x = rmsnorm(use(params["final_norm"]), x, cfg.norm_eps)
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
    x = rmsnorm(use(params["final_norm"]), x[:, -1:], cfg.norm_eps)
    logits = unembed(params, cfg, x)
    return logits, {"layers": new_caches,
                    "pos": torch.tensor(s, dtype=torch.int32,
                                        device=x.device)}


def decode_step(params, cfg: ModelConfig, tokens, state, *,
                opts: Optional[dict] = None):
    """One decode step.  tokens: (B, 1) int; state from
    ``init_decode_state`` (its caches are updated in place).  Returns
    (logits (B,1,V), new_state).

    Under a rules plan it runs inside ``BuiltJob.running(params,
    layout)``: ``tokens`` are the rank's rows under the rules' batch
    axes, each state leaf is the rank's part under its placement in
    ``layout`` (``launch.mesh.cache_shardings``), the logits are the
    rank's rows and vocab part, and the new state keeps the placements.
    ``pos`` is one scalar for every row or, from ``init_decode_state(...,
    per_row_pos=True)``, each row's own position: it lies whole on every
    rank (its placement is ``()``), and the rank takes its rows' under
    the batch axes."""
    opts = _resolve_opts(params, opts)
    pos = state["pos"]
    mine = pos
    if pos.ndim and pos.shape[0] != tokens.shape[0]:
        mine = C.local_slice(pos, 0, batch_axis())
    x = _embed_tokens(use(params["embed"]), tokens)
    layout = current_layout()
    x, new_caches, _ = _run_groups(
        params, cfg, x, caches=state["layers"], pos=mine, opts=opts,
        layout=None if layout is None else layout["layers"])
    x = rmsnorm(use(params["final_norm"]), x, cfg.norm_eps)
    logits = unembed(params, cfg, x)
    return logits, {"layers": new_caches, "pos": pos + 1}


def greedy_tokens(logits):
    """(B, 1) int32: the index of each row's largest last logit, ties to
    the lowest index as ``jnp.argmax`` breaks them.  Where the rules cut
    the vocab, each rank's (max, index) pair is all-gathered over the
    tensor-parallel axis and the first rank holding the row's max wins."""
    last = logits[:, -1]
    idx = torch.argmax(last, dim=-1, keepdim=True)
    tp = tp_for("vocab")
    if tp is not None:
        val = C.all_gather(last.gather(-1, idx), 1, tp)      # (B, ranks)
        idx = C.all_gather(idx + tp.rank * last.shape[-1], 1, tp)
        best = val.amax(-1, keepdim=True)
        idx = torch.where(val == best, idx, torch.iinfo(idx.dtype).max) \
            .amin(-1, keepdim=True)
    return idx.to(torch.int32)
