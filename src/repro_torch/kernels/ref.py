"""Plain PyTorch oracles for the port's kernels (the attention oracle
here; the mLSTM ones re-export the model layer's reference forms)."""
from __future__ import annotations

import torch

from ..models.blockwise import mlstm_chunked as _mlstm_chunked
from ..models.recurrent import mlstm_parallel_ref as _mlstm_parallel


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


def mlstm_ref(q, k, v, i_pre, f_pre):
    """Quadratic-form mLSTM."""
    return _mlstm_parallel(q, k, v, i_pre, f_pre)


def mlstm_chunked_ref(q, k, v, i_pre, f_pre, chunk: int = 256):
    return _mlstm_chunked(q, k, v, i_pre, f_pre, chunk=chunk)
