"""Recurrent mixer blocks: RG-LRU (Griffin / RecurrentGemma), and xLSTM's
mLSTM (matrix memory) and sLSTM (scalar memory), with the causal
depthwise conv they share.

Each block exposes ``<block>_spec(cfg)``, a full-sequence apply (train /
prefill) and a single-token decode apply carrying a small recurrent
state; ``<block>_state_spec`` gives that state as meta tensors.  The
layouts are the JAX package's: activations (B, S, ...), heads before
head_dim, recurrent matrices R[h, out, in].

Under tensor parallelism (``parallelism.context.tp_for``) each rank
holds the part of every weight that the plan's rules give it, and the
full-sequence applies (train and prefill) run on those parts: the
RG-LRU on its rnn channels, the mLSTM on its up-projection channels
(and its heads where the rules cut them), the sLSTM on its heads (the
recurrences split by channel or by head).  The block's input enters
through ``copy_in``; products over a split input dim are summed by a
reduce-scatter onto the rank's channels or heads (an all-reduce where
the heads stay whole), and the block's output by one all-reduce.  A
prefill returns the state of the rank's channels or heads.  A decode
step takes its tensor-parallel path too, on the rank's parts of a
decode state placed as ``launch.mesh.cache_shardings`` places it
(``place``), re-laying the small recurrent states where their cut is not
the weights'.  Where its rows are cut and the activations' are whole
(``rows``), the step projects every row, runs the recurrence on the
rank's rows and gathers them before the output projection; where the
weights stay in place (``parallelism.context.contract_for``), the
projections over and onto embed split their contraction
(``layers.embed_in`` / ``embed_out``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallelism import collectives as C
from ..parallelism.context import contract_for, tp_for
from .blockwise import mlstm_chunked
from .config import ModelConfig
from .layers import embed_in, embed_out, rmsnorm_spec, rows_in, rows_out
from .params import P
from .scan import scan
from .slstm_scan import slstm_scan, step_core

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


# ----------------------------------------------------------------- RG-LRU

_RGLRU_C = 8.0


def rglru_block_spec(cfg: ModelConfig):
    d, r = cfg.d_model, cfg.resolved_d_rnn
    return {
        "norm": rmsnorm_spec(d),
        "w_gelu": P((d, r), ("embed", "rnn")),
        "w_branch": P((d, r), ("embed", "rnn")),
        "conv": conv1d_spec(cfg.conv_width, r),
        "w_rec_gate": P((r, r), ("rnn", "rnn_in")),
        "w_in_gate": P((r, r), ("rnn", "rnn_in")),
        "lam": P((r,), ("rnn",), init="const", scale=4.0),  # a=sigmoid(4)≈.982
        "w_out": P((r, d), ("rnn", "embed")),
    }


def _rglru_coeffs(p, u, tp=None):
    """u: (..., r) post-conv branch.  Returns (a, b) of h = a*h_prev + b.
    Under ``tp`` u holds the rank's channels and the gates' rows are
    split with them: each gate is the rank's slice of the summed parts."""
    if tp is None:
        gate = lambda w: u @ w
    else:
        gate = lambda w: C.reduce_split(u @ w, -1, tp)
    r_gate = torch.sigmoid(gate(p["w_rec_gate"]))
    i_gate = torch.sigmoid(gate(p["w_in_gate"]))
    log_a = -_RGLRU_C * r_gate * F.softplus(p["lam"])  # log sigmoid(lam)^(c*r)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * (i_gate * u)
    return a, b


def rglru_scan_ref(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 (seq), h_0 = 0, in the inputs'
    dtype: a log-step (Hillis-Steele) scan, each pass combining every
    element with the one ``shift`` steps before it.  No step divides by a
    running product of a, which underflows within a few hundred steps."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        a_prev = F.pad(a[:, :-shift], (0, 0, shift, 0), value=1.0)
        b_prev = F.pad(b[:, :-shift], (0, 0, shift, 0))
        a, b = a * a_prev, a * b_prev + b
        shift *= 2
    return b


def rglru_block(p, x, cfg: ModelConfig, state: Optional[dict] = None,
                scan_fn=None, return_state: bool = False, place=None,
                rows=None):
    """Griffin recurrent block.  x: (B,S,d).  Returns (y, new_state).

    state=None: full sequence through ``scan_fn`` (a, b) -> h, by default
    ``rglru_scan_ref``; with ``return_state`` the decode state is h's
    last step (float32) and the conv tail.  state=dict: one decode step,
    x is (B, 1, d), h carried in float32.  Under ``tp`` the step runs on
    the rank's rnn channels; ``place`` gives the rank's axis of each
    state dim, and a state cut otherwise than the weights (h on dim 1,
    the conv tail on dim 2) is re-laid to the rank's channels and back
    (``collectives.relay``: an all-gather, a slice); ``rows``: the axis
    that cuts the state's rows where x holds every row."""
    tp = tp_for("rnn")
    if tp is not None:
        x = C.copy_in(x, tp)
    g, u = embed_in(torch.matmul, x, p["w_gelu"], p["w_branch"])
    gelu_branch = F.gelu(g, approximate="tanh")
    if state is None:
        a, b = _rglru_coeffs(p, conv1d(p["conv"], u), tp)
        h = (scan_fn or rglru_scan_ref)(a, b)
        y = (h * gelu_branch) @ p["w_out"]
        if tp is not None:
            y = C.reduce_out(y, tp)
        if return_state:
            return y, {"h": h[:, -1].float(), "conv": _conv_tail(p, u)}
        return y, None
    # ---- decode step
    ax_h = place["h"][1] if place else None
    ax_c = place["conv"][2] if place else None
    u_t, gate = rows_in(rows, u[:, 0], gelu_branch[:, 0])
    u_t, conv_state = conv1d_step(p["conv"], u_t,
                                  C.relay(state["conv"], 2, ax_c, tp))
    a, b = _rglru_coeffs(p, u_t, tp)
    h = a.float() * C.relay(state["h"], 1, ax_h, tp) + b.float()
    y = (rows_out(rows, h.to(x.dtype) * gate) @ p["w_out"])[:, None]
    if tp is not None:
        y = C.reduce_out(y, tp)
    return embed_out(y.to(x.dtype)), {
        "h": C.relay(h, 1, tp, ax_h), "conv": C.relay(conv_state, 2, tp, ax_c)}


def rglru_state_spec(cfg: ModelConfig, batch: int, dtype):
    r = cfg.resolved_d_rnn
    return {"h": torch.empty((batch, r), dtype=torch.float32, device="meta"),
            "conv": torch.empty((batch, cfg.conv_width - 1, r), dtype=dtype,
                                device="meta")}


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
                parallel_fn=None, return_state: bool = False, place=None,
                rows=None):
    """mLSTM block.  x: (B,S,d).  Returns (y, new_state).

    state=None: full sequence through ``parallel_fn`` (q, k, v, i_pre,
    f_pre) -> h, by default the quadratic form up to S 512 and the
    chunked form above; with ``return_state`` the chunked form also
    gives the final (C, n, m) for decode.  state=dict: one decode step
    (:func:`_mlstm_decode`), x is (B, 1, d)."""
    b, s, _ = x.shape
    tp = tp_for("ffn")
    if state is not None:
        return _mlstm_decode(p, x, cfg, state, tp, place, rows)
    if tp is not None:
        x = C.copy_in(x, tp)
    xin = x @ p["w_up"]
    z = x @ p["w_gate"]
    # under tp, on a rank's part of the up-projection channels (w_up,
    # w_gate, conv and the rows of wq/wk/wv/wi/wf, w_down).  Where
    # the rules cut the heads, the reduce-scatter of q, k, v and the
    # gate pre-activations gives the rank its heads, whose channels
    # are the rank's channels, so its h meets its own z.  Where they
    # do not, an all-reduce gives every rank every head, and each
    # takes its channels of h.
    cut_heads = tp is not None and tp_for("heads") is not None
    if tp is None:
        heads = lambda t: t
    elif cut_heads:
        heads = lambda t: C.reduce_split(t, 2, tp)
    else:
        heads = lambda t: C.reduce_out(t, tp)
    c = F.silu(conv1d(p["conv"], xin))
    q = heads(torch.einsum("bsu,uhd->bshd", c, p["wq"]))
    k = heads(torch.einsum("bsu,uhd->bshd", c, p["wk"]))
    v = heads(torch.einsum("bsu,uhd->bshd", xin, p["wv"]))
    i_pre = heads(torch.einsum("bsu,uh->bsh", c, p["wi"])) + p["bi"]
    f_pre = heads(torch.einsum("bsu,uh->bsh", c, p["wf"])) + p["bf"]
    new_state = None
    if return_state:
        h, (cmat, n, m) = mlstm_chunked(q, k, v, i_pre, f_pre,
                                        return_final=True)
        new_state = {"C": cmat, "n": n, "m": m,
                     "conv": _conv_tail(p, xin)}
    else:
        if parallel_fn is None:
            parallel_fn = (mlstm_chunked if s > _MLSTM_QUADRATIC_MAX_S
                           else mlstm_parallel_ref)
        h = parallel_fn(q, k, v, i_pre, f_pre)
    h = h.reshape(b, s, -1)
    if tp is not None and not cut_heads:
        h = C.split(h, 2, tp)
    out = (h * F.silu(z)) @ p["w_down"]
    if tp is not None:
        out = C.reduce_out(out, tp)
    return out, new_state


def _only(have, *dims):
    """A placement ``have`` (an axis or None a dim) with the cuts on
    ``dims`` and on the batch dim kept and every other dim whole."""
    return tuple(a if d == 0 or d in dims else None
                 for d, a in enumerate(have))


def _mlstm_decode(p, x, cfg: ModelConfig, state, tp, place, rows=None):
    """One mLSTM decode step; under ``tp`` on the rank's up-projection
    channels (the rules' "ffn" cut) and with ``place`` (the rank's axis
    of each state dim; None: the state whole) on the rank's parts of the
    state, its rows where ``rows`` cuts them.

    The step keeps C cut on its value dim and n on its key dim, as the
    decode state places them: q and k are summed whole over ``tp`` (all
    key rows of C), v to the rank's value slice, ``n . q`` is a partial
    sum all-reduced over n's axis, and ``C . q`` gives the rank's value
    slice of h, all-gathered into whole heads before the rank takes its
    up channels for ``z`` and ``w_down``.  Re-laid with a collective
    where the state's cut is not the step's (``collectives.relay_dims``):
    the stabilizer m is made whole (the state cuts it by heads where
    the heads divide), and so is a C or n cut on another dim, and the
    conv tail is laid on ``tp``'s channels; each goes back to its
    placement after the step.  The gate biases, cut by heads where the
    rules cut the heads, are gathered whole."""
    nh = cfg.num_heads
    dh = 2 * cfg.d_model // nh
    pl = place or {}
    have = {k: pl.get(k, (None,) * state[k].dim()) for k in state}
    want = {"C": _only(have["C"], 3), "n": _only(have["n"], 2),
            "m": _only(have["m"]),
            "conv": (have["conv"][0], None, tp)}
    st = {k: C.relay_dims(state[k], have[k], want[k]) for k in state}
    av, ak = want["C"][3], want["n"][2]
    whole = (lambda t: t) if tp is None else (lambda t: C.all_reduce(t, tp))
    bias = lambda t: C.relay(t, 0, tp_for("heads"), None)

    xin, z = embed_in(torch.matmul, x, p["w_up"], p["w_gate"])
    xin, z = rows_in(rows, xin[:, 0], z[:, 0])
    b = xin.shape[0]
    c_t, conv_state = conv1d_step(p["conv"], xin, st["conv"])
    c_t = F.silu(c_t)
    q = whole(torch.einsum("bu,uhd->bhd", c_t, p["wq"])) * (dh ** -0.5)
    k = whole(torch.einsum("bu,uhd->bhd", c_t, p["wk"]))
    v = torch.einsum("bu,uhd->bhd", xin, p["wv"])
    v = C.reduce_scatter(v, 2, tp) if tp is not None and av == tp \
        else C.relay(whole(v), 2, None, av)
    i_pre = (whole(c_t @ p["wi"]) + bias(p["bi"])).float()
    f_pre = (whole(c_t @ p["wf"]) + bias(p["bf"])).float()
    lf = F.logsigmoid(f_pre)
    m_new = torch.maximum(lf + st["m"], i_pre)
    fg = torch.exp(lf + st["m"] - m_new)[..., None]
    ig = torch.exp(i_pre - m_new)[..., None]
    k32, q32 = k.float(), q.float()
    cmat = fg[..., None] * st["C"] + ig[..., None] * (
        k32[..., :, None] * v.float()[..., None, :])
    n = fg * st["n"] + ig * C.relay(k32, 2, None, ak)
    num = torch.einsum("bhkv,bhk->bhv", cmat, q32)
    nq = torch.einsum("bhk,bhk->bh", n, C.relay(q32, 2, None, ak))
    if ak is not None:
        nq = C.all_reduce(nq, ak)
    den = torch.maximum(torch.abs(nq), torch.exp(-m_new))
    h = C.relay(num / den[..., None], 2, av, None).reshape(b, nh * dh)
    h = C.relay(h.to(x.dtype), 1, None, tp)
    out = rows_out(rows, h * F.silu(z)) @ p["w_down"]
    if tp is not None:
        out = C.reduce_out(out, tp)
    new = {"C": cmat, "n": n, "m": m_new, "conv": conv_state}
    return embed_out(out)[:, None], {k: C.relay_dims(t, want[k], have[k])
                                     for k, t in new.items()}


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
    pres = [gates_t[..., i] + torch.einsum("bhd,hed->bhe", h, p[r])
            for i, r in enumerate(("rz", "ri", "rf", "ro"))]
    c_new, n_new, m_new, h_new = step_core(*pres, c, n, m)
    return (c_new, n_new, m_new, h_new.to(h.dtype))


def slstm_block(p, x, cfg: ModelConfig, state: Optional[dict] = None,
                return_state: bool = False, slstm_fn=None,
                batched_grad: bool = False, place=None, rows=None):
    """sLSTM block.  x: (B,S,d).  Returns (y, new_state).

    state=None: the recurrence over the whole sequence, one
    ``_slstm_step`` a time step; with ``batched_grad`` the same scan
    runs as ``slstm_scan.slstm_scan``, whose backward computes dR once
    after the time loop.  With ``slstm_fn`` (and no state asked for) the
    recurrence is ``slstm_fn(gates, rz, ri, rf, ro) -> h`` in the
    signature of the sLSTM kernel instead.  At float32 these compute the
    same function.  Under bf16 the kernel differs: it carries h in
    float32 between steps, the step scans carry it in the activations'
    dtype, as the JAX package's does.  state=dict: one decode step
    (:func:`_slstm_decode`), x is (B, 1, d)."""
    b, s, d = x.shape
    tp = tp_for("heads")
    if state is not None:
        return _slstm_decode(p, x, cfg, state, tp, place, rows)
    if tp is not None:
        x = C.copy_in(x, tp)
    nh, dh = p["wz"].shape[1:]      # a rank's heads under ``tp``
    gates = torch.stack([
        torch.einsum("bsd,dhe->bshe", x, p["wz"]),
        torch.einsum("bsd,dhe->bshe", x, p["wi"]) + p["bi"],
        torch.einsum("bsd,dhe->bshe", x, p["wf"]) + p["bf"],
        torch.einsum("bsd,dhe->bshe", x, p["wo"]),
    ], dim=-1)  # (B,S,H,D,4)
    if slstm_fn is not None and not return_state:
        h = slstm_fn(gates, p["rz"], p["ri"], p["rf"], p["ro"])
        return _slstm_out(p, h.reshape(b, s, nh, dh), tp), None
    dev = x.device
    carry = (torch.zeros((b, nh, dh), device=dev),
             torch.zeros((b, nh, dh), device=dev),
             torch.full((b, nh, dh), -1e30, device=dev),
             torch.zeros((b, nh, dh), dtype=x.dtype, device=dev))
    if batched_grad:
        carry, hs = slstm_scan(p, gates.transpose(0, 1), carry)
        h = hs.transpose(0, 1)
    else:
        def trip(t, carry):
            carry = _slstm_step(p, carry, gates[:, t])
            return carry, carry[3]
        carry, h = scan(trip, carry, s, name="slstm", stack=("stack", 1))
    if return_state:
        c, n, m, h_last = carry
        return _slstm_out(p, h, tp), \
            {"c": c, "n": n, "m": m, "h": h_last}
    return _slstm_out(p, h, tp), None


def _slstm_decode(p, x, cfg: ModelConfig, state, tp, place, rows=None):
    """One sLSTM decode step; with ``place`` (the rank's axis of each dim
    of c, n, m and h, (B, heads, head_dim); None: the state whole) on
    the rank's parts of the state, its rows where ``rows`` cuts them.

    The step keeps the state's cut on head_dim: the rank computes the
    four pre-activations of its head_dim slice of every head, from the
    whole previous h (the recurrent matvec ``h . R`` contracts over all
    of head_dim, so h is all-gathered: B x heads x head_dim).  Where the
    rules leave the heads whole (``tp`` None) the rank takes its slice
    of the gate weights, the recurrent weights' output rows and the
    biases; where they cut the heads over ``tp``, the rank computes its
    heads' pre-activations whole and they are re-laid (all-gathered over
    the heads, then sliced on head_dim).  A state cut on another dim is
    made whole for the step and cut back after it
    (``collectives.relay_dims``).  The output is the rank's part of
    ``h . w_out`` (its head_dim slice of h against its rows of w_out),
    all-reduced; where the weights stay in place, w_out's rows are the
    rank's slice of embed, so h is made whole and meets them through
    ``layers.embed_in``."""
    d = x.shape[-1]
    pl = place or {}
    have = {k: pl.get(k, (None,) * state[k].dim()) for k in state}
    want = {k: _only(have[k], 2) for k in state}
    st = {k: C.relay_dims(state[k], have[k], want[k]) for k in state}
    h_prev = C.relay(st["h"], 2, want["h"][2], None)
    ae = want["c"][2]
    if want["h"][2] != ae:
        raise NotImplementedError(f"sLSTM state cut {have}")
    names = (("wz", "rz", None), ("wi", "ri", "bi"), ("wf", "rf", "bf"),
             ("wo", "ro", None))
    # the rank's rows of a weight cut on head_dim (dim ``e``) over ``ax``
    mine = lambda name, e, ax: C.relay(p[name], e, None, ax)
    ax = ae if tp is None else None
    gx = rows_in(rows, *embed_in(
        lambda x_, w: torch.einsum("bd,dhe->bhe", x_, w), x[:, 0],
        *(mine(w, 2, ax) for w, _, _ in names)))

    def pre(g, r, bias, h_in):
        if bias is not None:
            g = g + mine(bias, 1, ax)
        return g + torch.einsum("bhd,hed->bhe", h_in, mine(r, 1, ax))
    if tp is None:
        pres = [pre(g, r, bias, h_prev)
                for g, (_, r, bias) in zip(gx, names)]
    else:
        h_loc = C.local_slice(h_prev, 1, tp)
        pres = torch.stack([pre(g, r, bias, h_loc)
                            for g, (_, r, bias) in zip(gx, names)], dim=-1)
        pres = C.relay(C.relay(pres, 1, tp, None), 2, None, ae).unbind(-1)
    c, n, m, h = step_core(*pres, st["c"], st["n"], st["m"])
    h = h.to(state["h"].dtype)
    h_out = rows_out(rows, h)
    if ae is None or contract_for("embed") is not None:
        b = h_out.shape[0]
        y = embed_in(torch.matmul, C.relay(h_out, 2, ae, None).reshape(b, d),
                     p["w_out"])[0]
    else:
        # the rank's head_dim slice of every head meets its rows of
        # w_out, and the partial outputs are summed
        w_out = C.local_slice(p["w_out"].reshape(h.shape[1], -1, d), 1, ae)
        y = C.reduce_out(torch.einsum("bhe,hed->bd", h_out, w_out), ae)
    y = y[:, None]
    new = {"c": c, "n": n, "m": m, "h": h}
    return y, {k: C.relay_dims(t, want[k], have[k]) for k, t in new.items()}


def _slstm_out(p, h, tp):
    """h (B, S, heads, D) -> the block's output through w_out.  Under
    ``tp`` the rank's heads meet their rows of w_out (replicated, and
    taken through ``split``, whose backward all-gathers the rows'
    gradients into the whole one) and the partial outputs are summed."""
    b, s = h.shape[:2]
    if tp is None:
        return h.reshape(b, s, -1) @ p["w_out"]
    w = p["w_out"]
    rows = C.split(w.reshape(h.shape[2] * tp.size, -1, w.shape[-1]), 0, tp)
    return C.reduce_out(torch.einsum("bshe,hed->bsd", h, rows), tp)


def slstm_state_spec(cfg: ModelConfig, batch: int, dtype):
    nh = cfg.num_heads
    dh = cfg.d_model // nh
    meta = lambda dt=torch.float32: torch.empty((batch, nh, dh), dtype=dt,
                                                device="meta")
    return {"c": meta(), "n": meta(), "m": meta(), "h": meta(dtype)}
