"""sLSTM time scan with a batched-gradient backward.

Autograd through the plain step loop accumulates the recurrent-weight
gradient dR inside the backward time loop, one (H, D, D) product per
step and gate.  This ``torch.autograd.Function`` (the cuDNN-RNN trick,
the JAX package's custom VJP) instead:
  forward : the plain scan, saving the h sequence
  backward: one recompute scan (the (c, n, m) sequences) and one reverse
            scan that emits the per-step pre-activation cotangents; dR
            is then a single einsum over (S, B) after the loop.
The four recurrent matrices run as one batched product over the heads:
R[h, e, d] for gates z, i, f, o becomes W[h, d, 4 e + g].

Under bf16 the h carry stays in the activations' dtype, as in the
JAX package's scan (the sLSTM kernel carries it in float32 instead).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .scan import scan


def _stack_r(rz, ri, rf, ro):
    """(H, E, D) x 4 -> W (H, D, 4E) with W[h, d, 4e + g] = R_g[h, e, d]."""
    h, e, d = rz.shape
    return torch.stack([rz, ri, rf, ro], dim=-1).permute(0, 2, 1, 3) \
        .reshape(h, d, 4 * e)


def _pres(w, gx_t, h):
    """gx_t: (B,H,D,4) pre-activations from x; h: (B,H,D).  Returns
    gx_t + h R for all four gates."""
    b, nh, d = h.shape
    hr = torch.bmm(h.transpose(0, 1), w)              # (H, B, 4D)
    return gx_t + hr.view(nh, b, d, 4).transpose(0, 1)


def step_core(z_pre, i_pre, f_pre, o_pre, c, n, m):
    """One sLSTM state update from the four gate pre-activations (B,H,D)
    in the activations' dtype; (c, n, m) float32.  Returns (c', n', m',
    h') in float32.  ``recurrent._slstm_step`` runs it too."""
    z = torch.tanh(z_pre).float()
    i_pre = i_pre.float()
    lf = F.logsigmoid(f_pre.float())
    m_new = torch.maximum(lf + m, i_pre)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(i_pre - m_new)
    c_new = fg * c + ig * z
    n_new = torch.clamp(fg * n + ig, min=1e-6)
    h_new = torch.sigmoid(o_pre).float() * c_new / n_new
    return c_new, n_new, m_new, h_new


def _max_weight(a, b):
    """d max(a, b) / d a, with ties split evenly (JAX's rule)."""
    return (a > b).float() + 0.5 * (a == b).float()


def _step_vjp(pres, c, n, m, dc, dn, dm, dh):
    """Cotangents of ``step_core``'s inputs (pres, c, n, m) given those
    of its outputs (c', n', m', h'); all float32 but pres."""
    zp, ip, fp, op = (pres[..., g].float() for g in range(4))
    z = torch.tanh(zp)
    lf = F.logsigmoid(fp)
    a = lf + m
    m_new = torch.maximum(a, ip)
    fg = torch.exp(a - m_new)
    ig = torch.exp(ip - m_new)
    c_new = fg * c + ig * z
    n_raw = fg * n + ig
    n_new = torch.clamp(n_raw, min=1e-6)
    o = torch.sigmoid(op)
    # h' = o c' / n'
    do = dh * c_new / n_new
    dc_new = dc + dh * o / n_new
    dn_raw = (dn - dh * o * c_new / (n_new * n_new)) * (n_raw >= 1e-6)
    # c' = fg c + ig z, n_raw = fg n + ig
    dfg = dc_new * c + dn_raw * n
    dig = dc_new * z + dn_raw
    dz = dc_new * ig
    # fg = exp(lf + m - m'), ig = exp(i - m')
    dfg_arg = dfg * fg
    dig_arg = dig * ig
    dm_new = dm - dfg_arg - dig_arg
    wa = _max_weight(a, ip)
    da = dfg_arg + dm_new * wa
    dpres = torch.stack([dz * (1 - z * z),
                         dig_arg + dm_new * (1 - wa),
                         da * torch.sigmoid(-fp),
                         do * o * (1 - o)], dim=-1)
    return dpres, dc_new * fg, dn_raw * fg, da


def _scan(w, gates, c, n, m, h):
    """The forward scan over gates (S,B,H,D,4).  Returns the final
    (c, n, m, h) and the sequences of the states each step starts from:
    h_prev (S,B,H,D) in h's dtype and c, n, m in float32."""
    def trip(t, carry):
        c, n, m, h = carry
        c2, n2, m2, hf = step_core(*_pres(w, gates[t], h).unbind(-1), c, n, m)
        return (c2, n2, m2, hf.to(h.dtype)), (h, c, n, m)
    return scan(trip, (c, n, m, h), gates.shape[0], name="slstm_scan",
                stack=("stack", 0))


class _SlstmScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, gates, c0, n0, m0, h0, rz, ri, rf, ro):
        w = _stack_r(rz, ri, rf, ro)
        (c, n, m, h), (h_prev, _, _, _) = _scan(w, gates, c0, n0, m0, h0)
        ctx.save_for_backward(gates, c0, n0, m0, h0, rz, ri, rf, ro, h_prev)
        hs = torch.cat([h_prev[1:], h[None]])
        return c, n, m, h, hs

    @staticmethod
    def backward(ctx, dcf, dnf, dmf, dhf, dhs):
        gates, c0, n0, m0, h0, rz, ri, rf, ro, h_prev = ctx.saved_tensors
        w = _stack_r(rz, ri, rf, ro)
        # the (c, n, m) each step started from: an elementwise recompute
        _, (_, c_prev, n_prev, m_prev) = _scan(w, gates, c0, n0, m0, h0)
        w32 = w.float()
        zero = lambda t, g: torch.zeros(t.shape, dtype=torch.float32,
                                        device=t.device) if g is None \
            else g.float()
        dc, dn, dm, dh = (zero(t, g) for t, g in
                          ((c0, dcf), (n0, dnf), (m0, dmf), (h0, dhf)))
        dhs = zero(h_prev, dhs)
        s, b, nh, d = h_prev.shape
        dpres_seq = torch.empty(gates.shape, dtype=torch.float32,
                                device=gates.device)
        def trip(t, carry):
            dc, dn, dm, dh = carry
            pres = _pres(w, gates[t], h_prev[t])
            dpres, dc, dn, dm = _step_vjp(pres, c_prev[t], n_prev[t],
                                          m_prev[t], dc, dn, dm,
                                          dh + dhs[t])
            dpres_seq[t] = dpres
            # dh_prev through pres = gx + h R
            dh = torch.bmm(dpres.view(b, nh, 4 * d).transpose(0, 1),
                           w32.transpose(1, 2)).transpose(0, 1)
            return (dc, dn, dm, dh), None
        (dc, dn, dm, dh), _ = scan(trip, (dc, dn, dm, dh), s,
                                   name="slstm_scan_back", reverse=True)
        # the point of this module: ONE product over (S, B) for dR
        dw = torch.einsum("sbhd,sbhk->hdk", h_prev.float(),
                          dpres_seq.view(s, b, nh, 4 * d))
        dr = dw.view(nh, d, d, 4).permute(3, 0, 2, 1)   # [g, h, e, d]
        return (dpres_seq.to(gates.dtype), dc, dn, dm, dh.to(h0.dtype),
                *(dr[g].to(r.dtype) for g, r in enumerate((rz, ri, rf, ro))))


def slstm_scan(R, gates, init):
    """R: {rz, ri, rf, ro} each (H,D,D); gates: (S,B,H,D,4) pre-activations
    from x; init: (c, n, m, h).  Returns (final (c, n, m, h), h_seq
    (S,B,H,D)), differentiable in all of them."""
    c, n, m, h, hs = _SlstmScan.apply(gates, *init, R["rz"], R["ri"],
                                      R["rf"], R["ro"])
    return (c, n, m, h), hs
