"""The decoder's forward pass and next-token loss, written plainly.

- Each block: ``x + attention(rmsnorm(x))``, then ``+ ffn(rmsnorm(x))``.
- RMSNorm in float32: ``x / sqrt(mean(x^2) + eps) * scale``.
- Attention: rotary positions (the first and second halves of a head
  rotated against each other, frequencies ``theta^(-i / (D/2))``), q
  scaled by ``D^-1/2``, grouped kv heads (query head h reads kv head
  ``h // (H / Kv)``), a causal softmax with keys further back than
  ``window`` masked in a ``swa`` block.  The softmax is taken in its
  online form over blocks of 512 keys for blocks of 512 queries.
- Dense FFN: ``(silu(x Wg) * (x Wu)) Wo``.
- MoE FFN, each batch row routed on its own: softmax over the router's
  logits; the top k experts by probability, ties to the lower expert;
  their probabilities renormalised to sum to one; an expert takes at
  most ``C = max(4, ceil4(ceil(S k cf / E)))`` of the (token, choice)
  pairs, the lower token first and then the lower choice, and drops the
  rest; each kept pair adds ``w * (silu(x Wg_e) * (x Wu_e)) Wo_e``, a
  token's pairs in the order of their experts.  The load-balance loss of
  a row is ``E * sum_e(top1_share_e * mean_prob_e) * aux_weight``,
  averaged over the rows and summed over the layers.  Each expert's
  tokens are found one expert at a time and run in a slab of C rows,
  zero past the last.
- The loss: mean cross-entropy of token t + 1 from position t, plus the
  load-balance loss.

Each block is recomputed in the backward pass
(``torch.utils.checkpoint``), so a layer's activations are alive one
layer at a time.

The blocks of the softmax and the experts' slabs are where the program
puts them, and the products are taken in the same shapes: so the two
sides' float32 rounding agrees up to each router.  Where it does not, an
MoE route whose k-th and (k+1)-th experts are near-tied flips between
the two sides, and one flipped token moves the numbers that ``correct``
compares as far as the TF32 control does.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .params import layer_groups, nest


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (B, S, H, D), positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(half, device=x.device,
                                       dtype=torch.float32) / half)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


BLOCK = 512
NEG = -1e30


def causal_softmax_values(q, k, v, window: int):
    """softmax(q k^T + causal mask) v per kv head's group of query
    heads; q (B, S, H, D) pre-scaled, k and v (B, S, Kv, D)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    blk = min(BLOCK, s)
    n = s // blk
    if s % blk:
        raise ValueError(f"sequence {s} is not a multiple of {blk}")
    # (n, B, Kv, H/Kv, blk, D) queries, (n, B, Kv, blk, D) keys, values
    qs = q.reshape(b, n, blk, kv, h // kv, d).permute(1, 0, 3, 4, 2, 5)
    ks = k.reshape(b, n, blk, kv, d).permute(1, 0, 3, 2, 4)
    vs = v.reshape(b, n, blk, kv, d).permute(1, 0, 3, 2, 4)
    outs = []
    for i in range(n):
        qi = i * blk + torch.arange(blk, device=q.device)
        top = torch.full((b, kv, h // kv, blk), NEG, device=q.device)
        total = torch.zeros((b, kv, h // kv, blk), device=q.device)
        acc = torch.zeros((b, kv, h // kv, blk, d), device=q.device)
        for j in range(n):
            kj = j * blk + torch.arange(blk, device=q.device)
            sc = torch.einsum("bkqcd,bked->bkqce", qs[i], ks[j]).float()
            keep = kj[None, :] <= qi[:, None]
            if window:
                keep &= (qi[:, None] - kj[None, :]) < window
            sc = torch.where(keep, sc, torch.tensor(NEG, device=q.device))
            new = torch.maximum(top, sc.amax(-1))
            e = torch.exp(sc - new[..., None])
            fade = torch.exp(top - new)
            total = total * fade + e.sum(-1)
            acc = acc * fade[..., None] + torch.einsum(
                "bkqce,bked->bkqcd", e, vs[j].float())
            top = new
        outs.append((acc / torch.clamp(total, min=1e-30)[..., None])
                    .to(q.dtype))
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, d)


def attention(p, x, cfg: dict, window: int):
    hd = p["wq"].shape[-1]
    q = rope(torch.einsum("bsd,dhk->bshk", x, p["wq"]), cfg["rope_theta"])
    k = rope(torch.einsum("bsd,dhk->bshk", x, p["wk"]), cfg["rope_theta"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    out = causal_softmax_values(q * hd ** -0.5, k, v, window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def dense_ffn(p, x):
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["wo"])


def capacity(moe: dict, seq: int) -> int:
    cap = math.ceil(seq * moe["top_k"] * moe.get("capacity_factor", 1.25)
                    / moe["num_experts"])
    return max(4, (cap + 3) // 4 * 4)


def moe_ffn(p, x, moe: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    e, k = moe["num_experts"], moe["top_k"]
    cap = capacity(moe, s)
    probs = torch.softmax(x @ p["router"], dim=-1)           # (B, S, E)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_w = top_p / top_p.sum(-1, keepdim=True)
    share = F.one_hot(top_e[..., 0], e).float().mean(1)       # (B, E)
    aux = (e * (share * probs.mean(1)).sum(-1)
           * moe.get("router_aux_weight", 0.01)).mean()
    toks, slabs, weights = [], [], []
    for r in range(b):
        pair_e, pair_w = top_e[r].reshape(-1), top_w[r].reshape(-1)
        for ex in range(e):
            pairs = torch.nonzero(pair_e == ex).squeeze(1)[:cap]
            toks.append(pairs // k)
            slabs.append(F.pad(x[r, pairs // k], (0, 0, 0, cap - len(pairs))))
            weights.append(F.pad(pair_w[pairs], (0, cap - len(pairs))))
    xs = torch.stack(slabs).reshape(b, e, cap, -1)
    g = torch.einsum("becd,edf->becf", xs, p["wi_gate"])
    u = torch.einsum("becd,edf->becf", xs, p["wi_up"])
    y = torch.einsum("becf,efd->becd", F.silu(g) * u, p["wo"])
    y = y * torch.stack(weights).reshape(b, e, cap)[..., None]
    rows = []
    for r in range(b):
        out = torch.zeros_like(x[r])
        for ex in range(e):
            tok = toks[r * e + ex]
            out = out.index_add(0, tok, y[r, ex, :len(tok)])
        rows.append(out)
    return torch.stack(rows), aux


def block(p, x, cfg: dict, kind: str):
    window = cfg.get("window_size", 0) if kind == "swa" else 0
    eps = cfg["norm_eps"]
    x = x + attention(p["mixer"], rmsnorm(x, p["mixer"]["norm"], eps), cfg,
                      window)
    h = rmsnorm(x, p["ffn"]["norm"], eps)
    if cfg.get("moe"):
        y, aux = moe_ffn(p["ffn"], h, cfg["moe"])
    else:
        y, aux = dense_ffn(p["ffn"], h), torch.zeros((), device=x.device)
    return x + y, aux


def loss(params: Dict[str, torch.Tensor], cfg: dict, tokens):
    """(cross-entropy + load-balance loss, cross-entropy) of a batch of
    token rows (B, S)."""
    tree = nest(params)
    x = F.embedding(tokens.long(), tree["embed"])
    aux = torch.zeros((), device=x.device)
    for gi, (stacked, kinds, n) in enumerate(layer_groups(cfg)):
        group = tree["groups"][gi]
        for rep in range(n):
            for i, kind in enumerate(kinds):
                leaves = group[f"pos{i}_{kind}"]
                p = {part: {name: (t[rep] if stacked else t)
                            for name, t in leaves[part].items()}
                     for part in leaves}
                x, a = checkpoint(block, p, x, cfg, kind, use_reentrant=False)
                aux = aux + a
    x = rmsnorm(x, tree["final_norm"], cfg["norm_eps"])
    w = tree["embed"].t() if cfg.get("tie_embeddings", True) \
        else tree["unembed"]
    logits = torch.einsum("bsd,dv->bsv", x, w)
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1).long())
    return ce + aux, ce
