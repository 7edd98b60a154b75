"""Core NN layers: RMSNorm, RoPE, GQA attention (full / sliding-window,
train / prefill / decode-with-KV-cache) and the dense FFN.

Params are dicts of tensors from ``params.init_params``, in the JAX
package's layouts: attention is (B, S, H, D) and projections are
(d, heads, head_dim).

Under tensor parallelism (``parallelism.context.tp_for``) each rank
holds its heads (and its kv heads where the rules cut them) of the
attention projections and its ffn columns of the FFN: the block's input
enters through ``copy_in`` and its output leaves through one all-reduce
(``reduce_out``), Megatron's column and row splits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallelism import collectives as C
from ..parallelism.context import tp_for
from .config import ModelConfig
from .params import P

NEG_INF = -1e30

# ---------------------------------------------------------------- RMSNorm

def rmsnorm_spec(d: int) -> P:
    return P((d,), ("embed",), init="ones")


def rmsnorm(scale, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ------------------------------------------------------------------- RoPE

def rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].float() * freq     # (..., S, half)
    ang = ang[..., None, :]                       # (..., S, 1, half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- Attention

def attention_spec(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
        "norm": rmsnorm_spec(d),
    }


def _gqa_scores(q, k):
    """q: (B,S,H,D) k: (B,L,Kv,D) -> (B, Kv, Q, S, L) with H = Kv*Q."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, s, kvh, h // kvh, d)
    return torch.einsum("bskqd,blkd->bkqsl", q, k)


def _gqa_out(probs, v):
    """probs: (B,Kv,Q,S,L), v: (B,L,Kv,D) -> (B,S,H,D)."""
    b, kvh, qpk, s, _ = probs.shape
    out = torch.einsum("bkqsl,blkd->bskqd", probs, v)
    return out.reshape(b, s, kvh * qpk, v.shape[-1])


_BLOCKWISE_THRESHOLD = 2048


def attention(p, x, cfg: ModelConfig, *, window: int = 0,
              cache: Optional[dict] = None, positions=None, pos=None,
              attn_fn=None, return_cache: bool = False):
    """Causal (optionally windowed) GQA attention.

    cache=None  -> full-sequence (train / prefill); returns (y, None), or
                   (y, {"k", "v"}) with ``return_cache``.  Sequences
                   >= 2048 use blockwise online-softmax attention.
    cache=dict  -> single-token decode; x is (B, 1, d); cache holds k, v
                   of shape (B, L, Kv, D); ``pos`` is a scalar or a (B,)
                   tensor: the index the new token is written at.
    attn_fn     -> fused attention for the full-sequence path:
                   (q, k, v, window) -> out.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    dev = x.device
    if pos is not None:
        pos = torch.as_tensor(pos, device=dev)
    if positions is None:
        if pos is not None and pos.ndim == 0:
            positions = pos.to(torch.int32).expand(b, s)
        elif pos is not None:
            positions = pos[:, None].to(torch.int32)  # per-row pos
        else:
            positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :]

    tp = tp_for("heads") if cache is None else None
    if tp is not None:
        x = C.copy_in(x, tp)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k, v, kv_of = _project_kv(p, x, cfg, tp, whole=return_cache)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kv = (k, v)
    if kv_of is not None:
        k, v = k[:, :, kv_of], v[:, :, kv_of]
    scale = hd ** -0.5

    if cache is None:
        if attn_fn is not None:
            out = attn_fn(q * scale, k, v, window)
        elif s >= _BLOCKWISE_THRESHOLD:
            from .blockwise import blockwise_attention
            out = blockwise_attention(q * scale, k, v, window=window)
        else:
            scores = _gqa_scores(q * scale, k).float()
            i = torch.arange(s, device=dev)[:, None]
            j = torch.arange(s, device=dev)[None, :]
            mask = j <= i
            if window:
                mask &= (i - j) < window
            scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=dev))
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = _gqa_out(probs, v)
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
        if tp is not None:
            y = C.reduce_out(y, tp)
        if return_cache:
            return y, {"k": kv[0], "v": kv[1]}
        return y, None

    # ----- decode: write the new k/v at ``pos``, attend over the cache.
    # The cache is updated IN PLACE (the JAX package returns new arrays:
    # dynamic_update_slice for a scalar pos, a one-hot blend for a (B,)
    # pos); the returned dict holds the same tensors.  index_copy_ /
    # index_put_ write one row per slot instead of rewriting the cache.
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    j = torch.arange(L, device=dev)
    if pos.ndim == 0:
        idx = pos.reshape(1).long()
        ck.index_copy_(1, idx, k.to(ck.dtype))
        cv.index_copy_(1, idx, v.to(cv.dtype))
        mask = (j <= pos)[None]                   # (1, L)
        wpos = pos.reshape(1)
    else:
        rows = torch.arange(b, device=dev)
        ck.index_put_((rows, pos.long()), k[:, 0].to(ck.dtype))
        cv.index_put_((rows, pos.long()), v[:, 0].to(cv.dtype))
        mask = j[None] <= pos[:, None]            # (B, L)
        wpos = pos
    scores = _gqa_scores(q * scale, ck).float()   # (B,Kv,Q,1,L)
    if window:
        mask = mask & ((wpos[:, None] - j[None]) < window)
    scores = torch.where(mask[:, None, None, None, :], scores,
                         torch.tensor(NEG_INF, device=dev))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(probs, cv)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, {"k": ck, "v": cv}


def _project_kv(p, x, cfg: ModelConfig, tp, whole: bool):
    """(k, v, kv_of) of x.  Under ``tp`` the kv heads that the rules cut
    are the rank's.  Kv heads that they leave whole are replicated: the
    weights enter through ``copy_in``, since every rank adds only its q
    heads' part to their gradient, and each local q head takes its own
    kv head's columns (a local layout of one kv head per q head).  With
    ``whole`` (a prefill's cache) every kv head is projected, and
    ``kv_of`` picks each local q head's from them."""
    wk, wv = p["wk"], p["wv"]
    kv_of = None
    if tp is not None and tp_for("kv_heads") is None:
        heads = p["wq"].shape[1]
        kv_of = torch.arange(tp.rank * heads, (tp.rank + 1) * heads,
                             device=wk.device) // cfg.q_per_kv
        wk, wv = C.copy_in(wk, tp), C.copy_in(wv, tp)
        if not whole:
            wk, wv, kv_of = wk[:, kv_of], wv[:, kv_of], None
    return (torch.einsum("bsd,dhk->bshk", x, wk),
            torch.einsum("bsd,dhk->bshk", x, wv), kv_of)


def attn_cache_spec(cfg: ModelConfig, batch: int, length: int, dtype):
    """Meta tensors (shape and dtype, no storage) for one layer's cache."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    mk = lambda: torch.empty((batch, length, kv, hd), dtype=dtype,
                             device="meta")
    return {"k": mk(), "v": mk()}


# -------------------------------------------------------------- dense FFN

def ffn_spec(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": P((d, f), ("embed", "ffn")),
        "wi_up": P((d, f), ("embed", "ffn")),
        "wo": P((f, d), ("ffn", "embed")),
        "norm": rmsnorm_spec(d),
    }


def ffn(p, x):
    tp = tp_for("ffn")
    if tp is not None:
        x = C.copy_in(x, tp)
    g = F.silu(torch.einsum("bsd,df->bsf", x, p["wi_gate"]))
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    y = torch.einsum("bsf,fd->bsd", g * u, p["wo"])
    return y if tp is None else C.reduce_out(y, tp)
