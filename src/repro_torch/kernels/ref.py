"""Plain PyTorch oracles for the port's kernels."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, window: int = 0):
    """Naive causal GQA attention.  q pre-scaled: (B,S,H,D); k, v:
    (B,S,Kv,D).  Scores in float32, probabilities in q's dtype."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qr = q.reshape(b, s, kvh, h // kvh, d)
    scores = torch.einsum("bskqd,blkd->bkqsl", qr, k).float()
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    mask = j <= i
    if window:
        mask &= (i - j) < window
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkqsl,blkd->bskqd", p, v)
    return out.reshape(b, s, h, d)
