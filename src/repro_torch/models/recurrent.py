"""Recurrent mixer blocks of xLSTM: mLSTM (matrix memory) and sLSTM
(scalar memory), with the causal depthwise conv they share.

Each block exposes ``<block>_spec(cfg)``, a full-sequence apply (train /
prefill) and a single-token decode apply carrying a small recurrent
state; ``<block>_state_spec`` gives that state as meta tensors.  The
layouts are the JAX package's: activations (B, S, ...), heads before
head_dim, recurrent matrices R[h, out, in].
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .blockwise import mlstm_chunked
from .config import ModelConfig
from .layers import rmsnorm_spec
from .params import P

# ------------------------------------------------------------ causal conv

def conv1d_spec(width: int, channels: int):
    return {"w": P((width, channels), (None, "rnn"), init="normal", scale=0.5),
            "b": P((channels,), ("rnn",), init="zeros")}


def conv1d(p, x):
    """Causal depthwise conv, full sequence.  x: (B, S, C)."""
    w = p["w"]
    width = w.shape[0]
    s = x.shape[1]
    out = x * w[width - 1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[width - 1 - i]
    return out + p["b"]


def conv1d_step(p, x_t, conv_state):
    """x_t: (B, C); conv_state: (B, width-1, C) past inputs (oldest first).
    Returns (out (B, C), the new conv_state)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)   # (B, width, C)
    out = torch.einsum("bwc,wc->bc", window, p["w"]) + p["b"]
    return out, window[:, 1:]


def _conv_tail(p, x):
    """The last width-1 inputs of x (zero-padded on the left): the conv
    state that decode continues from."""
    w = p["conv"]["w"].shape[0]
    return F.pad(x, (0, 0, w - 1, 0))[:, -(w - 1):]


# ------------------------------------------------------------------ mLSTM

def mlstm_block_spec(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.num_heads
    up = 2 * d
    dh = up // h
    return {
        "norm": rmsnorm_spec(d),
        "w_up": P((d, up), ("embed", "ffn")),
        "w_gate": P((d, up), ("embed", "ffn")),
        "conv": conv1d_spec(cfg.conv_width, up),
        "wq": P((up, h, dh), ("ffn", "heads", "head_dim")),
        "wk": P((up, h, dh), ("ffn", "heads", "head_dim")),
        "wv": P((up, h, dh), ("ffn", "heads", "head_dim")),
        "wi": P((up, h), ("ffn", "heads"), init="normal", scale=0.1),
        "bi": P((h,), ("heads",), init="const", scale=-3.0),
        "wf": P((up, h), ("ffn", "heads"), init="normal", scale=0.1),
        "bf": P((h,), ("heads",), init="const", scale=3.0),
        "w_down": P((up, d), ("ffn", "embed")),
    }


def mlstm_parallel_ref(q, k, v, i_pre, f_pre):
    """Parallel (quadratic) mLSTM form.

    q, k, v: (B,S,H,D); i_pre, f_pre: (B,S,H) pre-activations.
    Returns h: (B,S,H,D) in q's dtype.
    """
    s, d = q.shape[1], q.shape[3]
    lf = F.logsigmoid(f_pre.float())                         # (B,S,H)
    cum = torch.cumsum(lf, dim=1)
    # log decay from j -> i: cum_i - cum_j (for j <= i), + i_tilde_j
    logd = cum[:, :, None, :] - cum[:, None, :, :]           # (B,S_i,S_j,H)
    logd = logd + i_pre.float()[:, None, :, :]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    logd = logd.masked_fill(~mask[None, :, :, None], float("-inf"))
    m = torch.amax(logd, dim=2, keepdim=True)                # (B,S,1,H)
    m = torch.clamp(m, min=-1e30)   # rows with all -inf
    dmat = torch.exp(logd - m)
    scores = torch.einsum("bihd,bjhd->bijh", q, k) * (d ** -0.5)
    c = scores.float() * dmat
    n = torch.maximum(torch.abs(torch.sum(c, dim=2)),
                      torch.exp(-m[:, :, 0]))                # (B,S,H)
    hout = torch.einsum("bijh,bjhd->bihd", c, v.float())
    return (hout / n[..., None]).to(q.dtype)


_MLSTM_QUADRATIC_MAX_S = 512


def mlstm_block(p, x, cfg: ModelConfig, state: Optional[dict] = None,
                parallel_fn=None, return_state: bool = False):
    """mLSTM block.  x: (B,S,d).  Returns (y, new_state).

    state=None: full sequence through ``parallel_fn`` (q, k, v, i_pre,
    f_pre) -> h, by default the quadratic form up to S 512 and the
    chunked form above; with ``return_state`` the chunked form also
    gives the final (C, n, m) for decode.  state=dict: one decode step,
    x is (B, 1, d)."""
    b, s, _ = x.shape
    nh = cfg.num_heads
    up = p["w_up"].shape[1]
    dh = up // nh
    xin = x @ p["w_up"]
    z = x @ p["w_gate"]
    if state is None:
        c = F.silu(conv1d(p["conv"], xin))
        q = torch.einsum("bsu,uhd->bshd", c, p["wq"])
        k = torch.einsum("bsu,uhd->bshd", c, p["wk"])
        v = torch.einsum("bsu,uhd->bshd", xin, p["wv"])
        i_pre = torch.einsum("bsu,uh->bsh", c, p["wi"]) + p["bi"]
        f_pre = torch.einsum("bsu,uh->bsh", c, p["wf"]) + p["bf"]
        if return_state:
            h, (C, n, m) = mlstm_chunked(q, k, v, i_pre, f_pre,
                                         return_final=True)
            out = h.reshape(b, s, up) * F.silu(z)
            return out @ p["w_down"], {"C": C, "n": n, "m": m,
                                       "conv": _conv_tail(p, xin)}
        if parallel_fn is None:
            parallel_fn = (mlstm_chunked if s > _MLSTM_QUADRATIC_MAX_S
                           else mlstm_parallel_ref)
        h = parallel_fn(q, k, v, i_pre, f_pre)
        out = h.reshape(b, s, up) * F.silu(z)
        return out @ p["w_down"], None
    # ---- decode step
    c_t, conv_state = conv1d_step(p["conv"], xin[:, 0], state["conv"])
    c_t = F.silu(c_t)
    q = torch.einsum("bu,uhd->bhd", c_t, p["wq"]) * (dh ** -0.5)
    k = torch.einsum("bu,uhd->bhd", c_t, p["wk"])
    v = torch.einsum("bu,uhd->bhd", xin[:, 0], p["wv"])
    i_pre = (c_t @ p["wi"] + p["bi"]).float()
    f_pre = (c_t @ p["wf"] + p["bf"]).float()
    lf = F.logsigmoid(f_pre)
    m_new = torch.maximum(lf + state["m"], i_pre)
    fg = torch.exp(lf + state["m"] - m_new)[..., None]
    ig = torch.exp(i_pre - m_new)[..., None]
    k32, q32 = k.float(), q.float()
    C = fg[..., None] * state["C"] + ig[..., None] * (
        k32[..., :, None] * v.float()[..., None, :])
    n = fg * state["n"] + ig * k32
    num = torch.einsum("bhkv,bhk->bhv", C, q32)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q32)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, up).to(x.dtype)
    out = (h * F.silu(z[:, 0])) @ p["w_down"]
    return out[:, None], {"C": C, "n": n, "m": m_new, "conv": conv_state}


def mlstm_state_spec(cfg: ModelConfig, batch: int, dtype):
    nh = cfg.num_heads
    up = 2 * cfg.d_model
    dh = up // nh
    meta = lambda shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                       device="meta")
    return {"C": meta((batch, nh, dh, dh)), "n": meta((batch, nh, dh)),
            "m": meta((batch, nh)),
            "conv": meta((batch, cfg.conv_width - 1, up), dtype)}


# ------------------------------------------------------------------ sLSTM

def slstm_block_spec(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    gate = lambda: P((d, h, dh), ("embed", "heads", "head_dim"), scale=0.5)
    rec = lambda: P((h, dh, dh), ("heads", "head_dim", "head_dim_in"),
                    scale=0.5)
    return {
        "norm": rmsnorm_spec(d),
        "wz": gate(), "wi": gate(), "wf": gate(), "wo": gate(),
        "rz": rec(), "ri": rec(), "rf": rec(), "ro": rec(),
        "bi": P((h, dh), ("heads", "head_dim"), init="const", scale=-3.0),
        "bf": P((h, dh), ("heads", "head_dim"), init="const", scale=3.0),
        "w_out": P((d, d), ("embed", "embed_out")),
    }


def _slstm_step(p, carry, gates_t):
    """carry: (c, n, m, h); gates_t: per-time pre-activations (B,H,D,4).
    c, n, m stay float32; h keeps its dtype (the activations')."""
    c, n, m, h = carry
    zx, ix, fx, ox = (gates_t[..., i] for i in range(4))
    z_pre = zx + torch.einsum("bhd,hed->bhe", h, p["rz"])
    i_pre = (ix + torch.einsum("bhd,hed->bhe", h, p["ri"])).float()
    f_pre = (fx + torch.einsum("bhd,hed->bhe", h, p["rf"])).float()
    o_pre = ox + torch.einsum("bhd,hed->bhe", h, p["ro"])
    z = torch.tanh(z_pre).float()
    lf = F.logsigmoid(f_pre)
    m_new = torch.maximum(lf + m, i_pre)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(i_pre - m_new)
    c_new = fg * c + ig * z
    n_new = torch.clamp(fg * n + ig, min=1e-6)
    h_new = (torch.sigmoid(o_pre).float() * c_new / n_new).to(h.dtype)
    return (c_new, n_new, m_new, h_new)


def slstm_block(p, x, cfg: ModelConfig, state: Optional[dict] = None,
                return_state: bool = False, slstm_fn=None):
    """sLSTM block.  x: (B,S,d).  Returns (y, new_state).

    state=None: the recurrence over the whole sequence, one
    ``_slstm_step`` a time step; with ``slstm_fn`` (and no state asked
    for) the recurrence is ``slstm_fn(gates, rz, ri, rf, ro) -> h`` in
    the signature of the sLSTM kernel instead.  At float32 the two
    compute the same function.  Under bf16 they differ: the kernel
    carries h in float32 between steps, the step scan carries it in the
    activations' dtype, as the JAX package's does.  state=dict: one
    decode step, x is (B, 1, d)."""
    b, s, d = x.shape
    nh = cfg.num_heads
    dh = d // nh
    gates = torch.stack([
        torch.einsum("bsd,dhe->bshe", x, p["wz"]),
        torch.einsum("bsd,dhe->bshe", x, p["wi"]) + p["bi"],
        torch.einsum("bsd,dhe->bshe", x, p["wf"]) + p["bf"],
        torch.einsum("bsd,dhe->bshe", x, p["wo"]),
    ], dim=-1)  # (B,S,H,D,4)
    if state is None:
        if slstm_fn is not None and not return_state:
            h = slstm_fn(gates, p["rz"], p["ri"], p["rf"], p["ro"])
            return h.reshape(b, s, d) @ p["w_out"], None
        dev = x.device
        carry = (torch.zeros((b, nh, dh), device=dev),
                 torch.zeros((b, nh, dh), device=dev),
                 torch.full((b, nh, dh), -1e30, device=dev),
                 torch.zeros((b, nh, dh), dtype=x.dtype, device=dev))
        hs = []
        for t in range(s):
            carry = _slstm_step(p, carry, gates[:, t])
            hs.append(carry[3])
        h = torch.stack(hs, dim=1).reshape(b, s, d)
        if return_state:
            c, n, m, h_last = carry
            return h @ p["w_out"], {"c": c, "n": n, "m": m, "h": h_last}
        return h @ p["w_out"], None
    carry = (state["c"], state["n"], state["m"], state["h"])
    new = _slstm_step(p, carry, gates[:, 0])
    y = (new[3].reshape(b, d) @ p["w_out"])[:, None]
    return y, {"c": new[0], "n": new[1], "m": new[2], "h": new[3]}


def slstm_state_spec(cfg: ModelConfig, batch: int, dtype):
    nh = cfg.num_heads
    dh = cfg.d_model // nh
    meta = lambda dt=torch.float32: torch.empty((batch, nh, dh), dtype=dt,
                                                device="meta")
    return {"c": meta(), "n": meta(), "m": meta(), "h": meta(dtype)}
