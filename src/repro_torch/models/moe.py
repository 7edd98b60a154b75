"""Mixture-of-Experts FFN: top-k routing with sort-based, capacity-bounded
dispatch (no (T, E, C) one-hot dispatch tensor) and a Switch-style
load-balance aux loss, the JAX package's function.

Each batch row is routed on its own, as the JAX package's per-row
``_route_row`` does, but all rows at once: every sort, count and gather
runs along the row's own axis.  Two tie rules decide routes and are
kept: among equal probabilities the lower expert index comes first in
the top-k (a stable descending sort, never ``torch.topk``), and an
expert at capacity keeps the lower token index, then the lower k (a
stable ``argsort``).  The router product stays in the activations'
dtype: under bf16 its rounding is part of the function, and it is where
most ties come from.

The combine adds each token's kept contributions in a fixed order
(expert id ascending, the order in which the JAX package's scatter-add
visits them) with no atomics, so a CUDA run is bit-for-bit repeatable.

Where the rules cut the experts over the tensor-parallel axis (expert
parallelism):
every rank routes the whole batch, the ``shard`` sites cut the
dispatched slabs and their gate weights to the rank's experts, each
rank combines its experts' share, and one all-reduce sums the shares.

Where a decode step keeps the weights in place
(``parallelism.context.contract_for``) the router and the experts'
``wi`` contract over the rank's slice of embed (``layers.embed_in``),
and the combined output, the rank's slice of embed, is all-gathered
(``layers.embed_out``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import spans
from ..parallelism import collectives as C
from ..parallelism.context import shard, tp_for
from .config import ModelConfig
from .layers import embed_in, embed_out, rmsnorm_spec
from .params import P


def moe_spec(cfg: ModelConfig):
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    return {
        "norm": rmsnorm_spec(d),
        "router": P((d, e), ("embed", None), scale=0.1),
        "wi_gate": P((e, d, f), ("experts", "embed", "ffn")),
        "wi_up": P((e, d, f), ("experts", "embed", "ffn")),
        "wo": P((e, f, d), ("experts", "ffn", "embed")),
    }


def moe_capacity(cfg: ModelConfig, tokens_per_row: int) -> int:
    m = cfg.moe
    cap = int(math.ceil(tokens_per_row * m.top_k * m.capacity_factor
                        / m.num_experts))
    return max(4, (cap + 3) // 4 * 4)


class Routes(NamedTuple):
    """One routing of x (B, S, d) to E experts of capacity C."""
    top_idx: torch.Tensor      # (B, S, k) experts, highest probability first
    tok_of_slot: torch.Tensor  # (B, E, C) token of each slot, 0 where empty
    w_of_slot: torch.Tensor    # (B, E, C) fp32 gate weight, 0 where empty
    slot_of_pair: torch.Tensor  # (B, S, k) e * C + c, -1 where dropped
    aux: torch.Tensor          # (B,) load-balance loss of each row


def route(p, x, cfg: ModelConfig, cap: int) -> Routes:
    """Sort-based capacity dispatch of every row of x (B, S, d), each row
    as the JAX package's ``_route_row`` routes it."""
    m = cfg.moe
    b, s, _ = x.shape
    k, e = m.top_k, m.num_experts
    logits = embed_in(torch.matmul, x, p["router"])[0].float()  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[..., :k], top_idx[..., :k]        # (B, S, k)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # load-balance aux (Switch-style), per row
    experts = torch.arange(e, device=x.device)
    density = (top_idx[..., :1] == experts).float().mean(1)  # (B, E)
    aux = e * torch.sum(density * probs.mean(1), -1) * m.router_aux_weight

    flat_eid = top_idx.reshape(b, s * k)
    flat_w = top_w.reshape(b, s * k)
    order = torch.argsort(flat_eid, dim=-1, stable=True)     # (B, S*k)
    s_tok, s_w = order // k, flat_w.gather(1, order)
    # each expert's group in the sorted order (bincount and one_hot
    # would wait on the device for their range checks)
    s_eid = flat_eid.gather(1, order)
    per_row = experts.expand(b, e).contiguous()
    starts = torch.searchsorted(s_eid, per_row)              # (B, E)
    sizes = torch.searchsorted(s_eid, per_row, right=True) - starts

    c = torch.arange(cap, device=x.device)
    slot = (starts[..., None] + c).clamp(0, s * k - 1).reshape(b, e * cap)
    valid = (c < sizes[..., None]).reshape(b, e * cap)
    tok_of_slot = torch.where(valid, s_tok.gather(1, slot), 0)
    w_of_slot = torch.where(valid, s_w.gather(1, slot), 0.0)

    # where each (token, k) pair landed: its place in the sorted order
    # (the inverse permutation) less its expert's start
    rank = torch.argsort(order, dim=-1)
    at = rank - starts.gather(1, flat_eid)
    slot_of_pair = torch.where(at < cap, flat_eid * cap + at, -1)
    return Routes(top_idx, tok_of_slot.reshape(b, e, cap),
                  w_of_slot.reshape(b, e, cap), slot_of_pair.reshape(b, s, k),
                  aux)


def combine(y, routes: Routes, first_expert: int = 0):
    """out[b, t] = the sum of y's slots that token t was routed to, added
    in y's dtype in expert order from zero; y: (B, E, C, d) weighted,
    the slabs of experts ``first_expert`` to ``first_expert + E - 1``
    (a rank's share under expert parallelism)."""
    b, e, cap, d = y.shape
    s, k = routes.slot_of_pair.shape[1:]
    by_expert = torch.argsort(routes.top_idx, dim=-1)
    slots = routes.slot_of_pair.gather(-1, by_expert) \
        - first_expert * cap                                 # (B, S, k)
    kept = (slots >= 0) & (slots < e * cap)
    picked = y.reshape(b, e * cap, d).gather(
        1, slots.clamp(0, e * cap - 1).reshape(b, s * k, 1)
        .expand(-1, -1, d))
    picked = torch.where(kept.reshape(b, s * k, 1), picked,
                         0).reshape(b, s, k, d)
    out = torch.zeros((b, s, d), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + picked[:, :, j]
    return out


def moe_ffn(p, x, cfg: ModelConfig):
    """x: (B, S, d) -> (out, aux_loss).  Every expert computes its whole
    (C, d) slab, padding slots included.  The spans ``moe.route``,
    ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` tile the
    function; under a profiler each forward counts the kept (token, k)
    pairs, the slab rows and the pairs (``moe.pairs_kept``,
    ``moe.slots``, ``moe.pairs``)."""
    with spans.span("moe.route"):
        routes = route(p, x, cfg, moe_capacity(cfg, x.shape[1]))
        if spans.counting():
            spans.count("moe.pairs_kept", (routes.slot_of_pair >= 0).sum())
            spans.count("moe.slots", routes.tok_of_slot.numel())
            spans.count("moe.pairs", routes.slot_of_pair.numel())
    b, e, cap = routes.tok_of_slot.shape
    d = x.shape[-1]
    with spans.span("moe.dispatch"):
        xg = x.gather(1, routes.tok_of_slot.reshape(b, e * cap, 1)
                      .expand(-1, -1, d)).reshape(b, e, cap, d)
        xg = shard(xg, "batch", "experts", None, None)
    with spans.span("moe.experts"):
        g, u = embed_in(lambda x_, w: torch.einsum("becd,edf->becf", x_, w),
                        xg, p["wi_gate"], p["wi_up"])
        y = torch.einsum("becf,efd->becd", F.silu(g) * u,
                         p["wo"])                            # (B,E,C,d)
        y = shard(y, "batch", "experts", None, None)
        w = shard(routes.w_of_slot, "batch", "experts", None)
        y = y * w[..., None].to(y.dtype)
    with spans.span("moe.combine"):
        tp = tp_for("experts")
        if tp is None:
            return embed_out(combine(y, routes)), routes.aux.mean()
        out = combine(y, routes, first_expert=tp.rank * y.shape[1])
        return embed_out(C.reduce_out(out, tp)), routes.aux.mean()
