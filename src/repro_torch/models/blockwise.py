"""Memory-efficient full-sequence attention in plain PyTorch: the plain
path of ``layers.attention`` at S >= 2048 (the hand-written kernel in
``repro_torch.kernels`` is the fast version of the same math)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def blockwise_attention(q, k, v, *, window: int = 0, q_chunk: int = 512,
                        kv_chunk: int = 512):
    """Causal (optionally sliding-window) GQA attention with an online
    softmax over kv chunks; never materializes (S, S).

    q: (B, S, H, D) pre-scaled; k, v: (B, S, Kv, D).  Returns (B, S, H, D).
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qpk = h // kvh
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s)
    if s % q_chunk or s % kv_chunk:
        raise ValueError(f"seq {s} not a multiple of the chunks "
                         f"({q_chunk}, {kv_chunk})")
    nq, nk = s // q_chunk, s // kv_chunk
    dev = q.device
    # (nq, B, Kv, Q, qc, D) / (nk, B, Kv, kc, D)
    qr = q.reshape(b, nq, q_chunk, kvh, qpk, d).permute(1, 0, 3, 4, 2, 5)
    kr = k.reshape(b, nk, kv_chunk, kvh, d).permute(1, 0, 3, 2, 4)
    vr = v.reshape(b, nk, kv_chunk, kvh, d).permute(1, 0, 3, 2, 4)

    outs = []
    for qi in range(nq):
        qc = qr[qi]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, kvh, qpk, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, qpk, q_chunk), device=dev)
        acc = torch.zeros((b, kvh, qpk, q_chunk, d), device=dev)
        for kj in range(nk):
            k_pos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            scores = torch.einsum("bkqcd,bked->bkqce", qc, kr[kj]).float()
            mask = k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            scores = torch.where(mask, scores,
                                 torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkqce,bked->bkqcd", p, vr[kj].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    # (nq, B, Kv, Q, qc, D) -> (B, S, H, D)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, d)
