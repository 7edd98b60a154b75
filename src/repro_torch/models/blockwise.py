"""Memory-efficient full-sequence primitives in plain PyTorch (the
hand-written kernels in ``repro_torch.kernels`` are the fast versions of
the same math).

- ``blockwise_attention``: the plain path of ``layers.attention`` at
  S >= 2048: online-softmax attention that never materializes (S, S).
- ``mlstm_chunked``: chunkwise-parallel mLSTM -- quadratic only within a
  chunk, recurrent (C, n, m) state across chunks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import spans
from .scan import scan

NEG_INF = -1e30


def _kv_blocks(q_lo: int, q_hi: int, window: int, kv_chunk: int):
    """The kv blocks that rows ``q_lo .. q_hi`` see, as ``(first, lo, hi,
    end)``: blocks ``first .. lo-1`` cross the window's edge, ``lo ..
    hi-1`` lie wholly inside the window and below the diagonal, and
    ``hi .. end-1`` cross the diagonal.  A block crosses the diagonal where its
    last key lies past ``q_lo`` and the window's edge where its first key
    lies ``window`` or more before ``q_hi``; the first set is a suffix of
    the blocks seen and the second a prefix, so the unmasked blocks are
    the run between them (none: every block counts as leading)."""
    first = max(0, q_lo - window + 1) // kv_chunk if window else 0
    end = q_hi // kv_chunk + 1
    plain = [j for j in range(first, end)
             if (j + 1) * kv_chunk - 1 <= q_lo
             and not (window and q_hi - j * kv_chunk >= window)]
    if not plain:
        return first, end, end, end
    return first, plain[0], plain[-1] + 1, end


def blockwise_attention(q, k, v, *, window: int = 0, q_chunk: int = 512,
                        kv_chunk: int = 512):
    """Causal (optionally sliding-window) GQA attention with an online
    softmax over kv chunks; never materializes (S, S).

    q: (B, S, H, D) pre-scaled; k, v: (B, S, Kv, D).  Returns (B, S, H, D).

    A q block visits only the kv blocks that hold a key one of its rows
    sees (``_kv_blocks``), and masks only those that cross the causal
    diagonal or the window's edge.  A block past the diagonal would add
    ``p = 0`` under ``corr = 1``, and one before the window's edge a sum
    that the first seen block multiplies by ``corr = 0``: skipping them
    leaves every output and gradient bit for bit as it was.  Under
    :func:`spans.counting` the forward counts the pairs visited
    (``attention.blocks_run``) and all pairs (``attention.blocks``).

    The q blocks run as a plain loop, since they visit different numbers
    of kv blocks; each visits its kv blocks as three ``scan`` loops in
    order (the window's edge, the unmasked run, the diagonal), each of
    trips alike, so the step analyzer charges a loop of 5 or more trips
    from four of them (``models.scan``).
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
    blocks = [_kv_blocks(qi * q_chunk, (qi + 1) * q_chunk - 1, window,
                         kv_chunk) for qi in range(nq)]
    if spans.counting():
        spans.count("attention.blocks_run",
                    sum(end - first for first, _, _, end in blocks))
        spans.count("attention.blocks", nq * nk)

    def q_trip(qi):
        qc = qr[qi]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=dev)

        def kv_trips(start, masked):
            def kv_trip(t, carry):
                kj = start + t
                m, l, acc = carry
                scores = torch.einsum("bkqcd,bked->bkqce", qc,
                                      kr[kj]).float()
                if masked:
                    k_pos = kj * kv_chunk + torch.arange(kv_chunk,
                                                         device=dev)
                    mask = k_pos[None, :] <= q_pos[:, None]
                    if window:
                        mask &= (q_pos[:, None] - k_pos[None, :]) < window
                    scores = torch.where(mask, scores, NEG_INF)
                m_new = torch.maximum(m, scores.amax(-1))
                p = torch.exp(scores - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bkqce,bked->bkqcd", p, vr[kj].float())
                return (m_new, l, acc), None
            return kv_trip

        first, lo, hi, end = blocks[qi]
        carry = (torch.full((b, kvh, qpk, q_chunk), NEG_INF, device=dev),
                 torch.zeros((b, kvh, qpk, q_chunk), device=dev),
                 torch.zeros((b, kvh, qpk, q_chunk, d), device=dev))
        for start, stop, masked, name in (
                (first, lo, True, "attention_kv_window_edge"),
                (lo, hi, False, "attention_kv"),
                (hi, end, True, "attention_kv_diagonal")):
            if stop > start:
                carry, _ = scan(kv_trips(start, masked), carry,
                                stop - start, name=name)
        _, l, acc = carry
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.to(q.dtype)

    # (nq, B, Kv, Q, qc, D) -> (B, S, H, D)
    outs = torch.stack([q_trip(qi) for qi in range(nq)], 0)
    return outs.permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, d)


def mlstm_chunked(q, k, v, i_pre, f_pre, *, chunk: int = 256,
                  return_final: bool = False):
    """Chunkwise-parallel mLSTM (matches ``mlstm_parallel_ref``).

    q, k, v: (B,S,H,D); i_pre, f_pre: (B,S,H).  Returns (B,S,H,D) in q's
    dtype, or ((B,S,H,D), (C, n, m)) when ``return_final`` (prefill ->
    decode), with C (B,H,D,D), n (B,H,D) and m (B,H) in float32."""
    b, s, h, d = q.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not a multiple of the chunk {chunk}")
    scale = d ** -0.5
    dev = q.device
    it_all = i_pre.float()
    lf_all = F.logsigmoid(f_pre.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))
    C = torch.zeros((b, h, d, d), device=dev)
    n = torch.zeros((b, h, d), device=dev)
    m = torch.full((b, h), NEG_INF, device=dev)

    def trip(i, carry):
        C, n, m = carry
        sl = slice(i * chunk, (i + 1) * chunk)
        qt, kt, vt = q[:, sl], k[:, sl], v[:, sl]        # (B,L,H,D)
        it, lft = it_all[:, sl], lf_all[:, sl]           # (B,L,H)
        cum = torch.cumsum(lft, dim=1)                   # inclusive
        g = cum[:, -1]                                   # (B,H) total decay
        # intra-chunk log decay matrix: cum_i - cum_j + i_j for j <= i
        logd = cum[:, :, None, :] - cum[:, None, :, :] + it[:, None, :, :]
        logd = logd.masked_fill(~tri[None, :, :, None], float("-inf"))
        m_intra = torch.amax(logd, dim=2)                # (B,L,H)
        m_inter = cum + m[:, None, :]                    # (B,L,H)
        m_i = torch.clamp(torch.maximum(m_intra, m_inter), min=NEG_INF)
        dmat = torch.exp(logd - m_i[:, :, None, :])
        scores = torch.einsum("blhd,bjhd->bljh", qt, kt) * scale
        cmat = scores.float() * dmat                     # (B,L,L,H)
        inter_w = torch.exp(m_inter - m_i)               # (B,L,H)
        q32 = qt.float() * scale
        h_inter = torch.einsum("blhk,bhkv->blhv", q32, C) * inter_w[..., None]
        n_inter = torch.einsum("blhk,bhk->blh", q32, n) * inter_w
        h_intra = torch.einsum("bljh,bjhv->blhv", cmat, vt.float())
        n_total = torch.sum(cmat, dim=2) + n_inter
        denom = torch.maximum(torch.abs(n_total), torch.exp(-m_i))
        out = ((h_intra + h_inter) / denom[..., None]).to(q.dtype)
        # ---- state update
        m_next = torch.maximum(g + m, torch.amax(it + g[:, None] - cum, dim=1))
        decay = torch.exp(g + m - m_next)                # (B,H)
        w_in = torch.exp(it + g[:, None] - cum - m_next[:, None])  # (B,L,H)
        k32 = kt.float()
        C = decay[..., None, None] * C + torch.einsum(
            "blh,blhk,blhv->bhkv", w_in, k32, vt.float())
        n = decay[..., None] * n + torch.einsum("blh,blhk->bhk", w_in, k32)
        return (C, n, m_next), out

    (C, n, m), out = scan(trip, (C, n, m), s // chunk, name="mlstm_chunked",
                          stack=("cat", 1))
    return (out, (C, n, m)) if return_final else out
