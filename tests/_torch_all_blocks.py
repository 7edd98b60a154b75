"""``all_blocks_attention``: blockwise attention that visits every
(q block, kv block) pair and masks each one, the form
``repro_torch.models.blockwise.blockwise_attention`` took before it
learned to skip the pairs no row sees.  The tests hold the skipping form
bit for bit to it.  Imports torch alone, so it runs on the card too."""
import torch

NEG_INF = -1e30


def all_blocks_attention(q, k, v, *, window: int = 0, q_chunk: int = 512,
                         kv_chunk: int = 512):
    """q: (B, S, H, D) pre-scaled; k, v: (B, S, Kv, D).  Returns
    (B, S, H, D), every kv block visited by every q block."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qpk = h // kvh
    q_chunk, kv_chunk = min(q_chunk, s), min(kv_chunk, s)
    nq, nk = s // q_chunk, s // kv_chunk
    dev = q.device
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
    return torch.stack(outs, 0).permute(1, 0, 4, 2, 3, 5).reshape(
        b, s, h, d)


def forward_backward(attn, q, k, v, seed: int = 0):
    """``attn(q, k, v)``'s output and the gradients of q, k and v under
    a fixed random cotangent drawn from ``seed``."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = attn(q, k, v)
    g = torch.randn(out.shape, generator=torch.Generator(
        device=out.device).manual_seed(seed), device=out.device,
        dtype=out.dtype)
    out.backward(g)
    return out.detach(), q.grad, k.grad, v.grad
