"""Core NN layers: RMSNorm, RoPE, GQA attention (full / sliding-window,
train / prefill / decode-with-KV-cache) and the dense FFN.

Params are dicts of tensors from ``params.init_params``, in the JAX
package's layouts: attention is (B, S, H, D) and projections are
(d, heads, head_dim).

Under tensor parallelism (``parallelism.context.tp_for``) each rank
holds its heads (and its kv heads where the rules cut them) of the
attention projections and its ffn columns of the FFN: the block's input
enters through ``copy_in`` and its output leaves through one all-reduce
(``reduce_out``), Megatron's column and row splits.  A decode step
(``_decode``), at one position for every row or at each row's own,
runs under tensor parallelism too, and on a KV cache cut by kv heads,
head_dim or sequence (a rules plan's decode state).

Where a decode step keeps the weights where they lie
(``parallelism.context.contract_for``: a rules plan's decode with the
batch whole), each weight matrix is the rank's slice of "embed" over
data: a projection over embed takes the rank's slice of the whole
activation and all-reduces the partial sums (:func:`embed_in`), one
that writes embed all-gathers the rank's slice (:func:`embed_out`), so
the residual stream stays whole between blocks.  Every block, the
embedding and the unembedding project through them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallelism import collectives as C
from ..parallelism.context import contract_for, tp_for
from .config import ModelConfig
from .params import P

NEG_INF = -1e30

# ------------------------------------------------- weights kept in place

def embed_in(f, x, *ws):
    """``[f(x, w) for w in ws]``, each contracting x's last dim (embed)
    against w's.  Where a decode step keeps the weights in place
    (``contract_for("embed")``) each w holds the rank's slice of embed:
    the rank's slice of x meets it, and the partial sums are all-reduced
    over that axis, one collective for all of them."""
    ax = contract_for("embed")
    if ax is None:
        return [f(x, w) for w in ws]
    x = C.local_slice(x, -1, ax)
    ys = [f(x, w) for w in ws]
    C.all_reduce_buckets(ys, ax)
    return ys


def embed_out(y):
    """``y``, whose last dim (embed) a projection wrote, whole: where a
    decode step keeps the weights in place it holds the rank's slice,
    all-gathered over the axis."""
    ax = contract_for("embed")
    return y if ax is None else C.all_gather(y, -1, ax)


def rows_in(rows, *ts):
    """The rank's rows (dim 0) of each of ``ts`` where a decode state's
    rows are cut over ``rows`` and the activations' are whole
    (``transformer._state_rows``)."""
    return [t if rows is None else C.local_slice(t, 0, rows) for t in ts]


def rows_out(rows, t):
    """``t`` on every row again: :func:`rows_in`'s converse."""
    return t if rows is None else C.all_gather(t, 0, rows)


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
              attn_fn=None, return_cache: bool = False, place=None,
              rows=None):
    """Causal (optionally windowed) GQA attention.

    cache=None  -> full-sequence (train / prefill); returns (y, None), or
                   (y, {"k", "v"}) with ``return_cache``.  Sequences
                   >= 2048 use blockwise online-softmax attention.
    cache=dict  -> single-token decode (:func:`_decode`); x is (B, 1, d);
                   cache holds k, v of shape (B, L, Kv, D); ``pos`` is
                   the index the new token is written at, a scalar or a
                   (B,) tensor, each row at its own position (continuous
                   batching); ``place``: the rank's axis of each cache
                   dim; ``rows``: the axis that cuts the cache's rows
                   where x holds every row (:func:`rows_in`).
    attn_fn     -> fused attention for the full-sequence path:
                   (q, k, v, window) -> out.
    """
    if cache is not None:
        return _decode(p, x, cfg, window, cache,
                       torch.as_tensor(pos, device=x.device), place, rows)
    s = x.shape[1]
    hd = cfg.resolved_head_dim
    dev = x.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :]

    tp = tp_for("heads")
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


def _decode(p, x, cfg: ModelConfig, window, cache, pos, place, rows=None):
    """One decode step on the rank's part of the cache and of the
    weights, at ``pos``: a scalar for every row, or a (B,) tensor of
    each row's position (the rank's rows under the rules' batch axes,
    ``transformer.decode_step``).  ``place`` gives the rank's axis of
    each cache dim (B, L, Kv, D; None: the cache whole); where it cuts
    the rows and x holds every row (``rows``), q, k and v are projected
    for every row, the rank attends for its rows (and takes their
    positions), and the output is gathered over the rows before ``wo``.
    Rope takes each row's position, the mask and the window each row's.
    The cache is updated in place (the JAX package's
    ``dynamic_update_slice``, or its one-hot blend for a (B,) ``pos``,
    returns a new array): one ``index_put_`` writes each row's token at
    its position instead of rewriting the cache.  The cache never
    leaves the rank: only one token's q, k and v, the scores, the
    softmax statistics and the attention output move.

    - q, k and v are projected on the rank's heads (and kv heads) where
      the rules cut the weights, roped whole along head_dim, and then
      re-laid to the cache's layout: the q heads of the rank's kv heads,
      the rank's slice of head_dim (``collectives.relay``).  Where the
      kv heads are whole and head_dim is cut, k and v are projected on
      the rank's slice of head_dim only (k's slices gathered for rope).
    - head_dim cut: the scores are partial sums, all-reduced before the
      softmax; ``probs . v`` gives the rank's slice of the output.
    - sequence cut: the rank holds positions ``offset + arange(L)``,
      which the mask and the window read; row r's new k and v are
      written only by the rank that holds its position (elsewhere the
      row is written back as it was), and the softmax is taken across
      the sequence's ranks in fp32: the row max, then the sum of
      exponentials and the weighted values in one all-reduce.
    - The output is re-laid to ``wo``'s heads (all-gathered along
      head_dim where that was cut), and the rank's part of the output
      projection is summed over the tensor-parallel axis.
    - q, k, v and the output projection go through :func:`embed_in` and
      :func:`embed_out`: where the weights stay in place they split
      their contraction over embed."""
    _, ax_s, ax_k, ax_d = place or (None,) * 4
    tp, tp_kv = tp_for("heads"), tp_for("kv_heads")
    dev = x.device
    proj = lambda x_, w: torch.einsum("bsd,dhk->bshk", x_, w)
    wk, wv = p["wk"], p["wv"]
    # whole kv heads, a head_dim cut: the rank projects its slice of
    # head_dim, and k's slices are gathered for rope, which pairs the
    # two halves of head_dim
    dim_cut = tp_kv is None and ax_d is not None
    if dim_cut:
        wk, wv = C.local_slice(wk, 2, ax_d), C.local_slice(wv, 2, ax_d)
    q, k, v = rows_in(rows, *embed_in(proj, x, p["wq"], wk, wv))
    b = q.shape[0]
    pos = rows_in(rows, pos)[0] if pos.ndim else pos.expand(b)
    positions = pos.to(torch.int32)[:, None]
    q = rope(q, positions, cfg.rope_theta)
    q = C.relay(C.relay(q, 2, tp, ax_k), 3, None, ax_d)
    if dim_cut:
        k = rope(C.all_gather(k, 3, ax_d), positions, cfg.rope_theta)
        k = C.relay(C.local_slice(k, 3, ax_d), 2, None, ax_k)
        v = C.relay(v, 2, None, ax_k)
    else:
        k = rope(k, positions, cfg.rope_theta)
        k = C.relay(C.relay(k, 2, tp_kv, ax_k), 3, None, ax_d)
        v = C.relay(C.relay(v, 2, tp_kv, ax_k), 3, None, ax_d)

    ck, cv = cache["k"], cache["v"]
    n = ck.shape[1]
    offset = ax_s.rank * n if ax_s is not None else 0
    at = pos.long() - offset
    idx = (torch.arange(b, device=dev), at.clamp(0, n - 1))
    k, v = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)   # (b, Kv, D)
    if ax_s is not None:
        owns = ((at >= 0) & (at < n))[:, None, None]
        k = torch.where(owns, k, ck[idx])
        v = torch.where(owns, v, cv[idx])
    ck.index_put_(idx, k)
    cv.index_put_(idx, v)
    j = offset + torch.arange(n, device=dev)
    mask = j <= pos[:, None]                                # (b, n)
    if window:
        mask = mask & ((pos[:, None] - j) < window)
    scores = _gqa_scores(q * cfg.resolved_head_dim ** -0.5, ck)
    if ax_d is not None:
        scores = C.all_reduce(scores, ax_d)
    scores = torch.where(mask[:, None, None, None], scores.float(),
                         NEG_INF)                           # (b,Kv,Q,1,n)
    if ax_s is None:
        out = _gqa_out(torch.softmax(scores, dim=-1).to(x.dtype), cv)
    else:
        top = C.all_reduce(scores.amax(-1, keepdim=True), ax_s,
                           op=dist.ReduceOp.MAX)
        e = torch.exp(scores - top)
        den = e.sum(-1).permute(0, 3, 1, 2).reshape(b, 1, -1, 1)
        both = C.all_reduce(torch.cat([_gqa_out(e, cv.float()), den], -1),
                            ax_s)
        out = (both[..., :-1] / both[..., -1:]).to(x.dtype)
    out = rows_out(rows, C.relay(C.relay(out, 3, ax_d, None), 2, ax_k, tp))
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    if tp is not None:
        y = C.reduce_out(y, tp)
    return embed_out(y), {"k": ck, "v": cv}


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
    g, u = embed_in(lambda x_, w: torch.einsum("bsd,df->bsf", x_, w), x,
                    p["wi_gate"], p["wi_up"])
    y = torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["wo"])
    return embed_out(y if tp is None else C.reduce_out(y, tp))
