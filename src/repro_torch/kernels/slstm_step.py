"""sLSTM recurrence forward (xLSTM scalar memory).

``slstm_step_scan(gates, rz, ri, rf, ro)`` has the signature of the JAX
package's Pallas kernel: gates (B, S, H, D, 4) pre-activations (z, i, f,
o, biases included), rz, ri, rf, ro (H, D, D) recurrent weights as
R[h, out, in]; out: the h sequence (B, S, H, D) in gates' dtype.  The
state c, n, m and h is float32 throughout, as are the R products.

On a CUDA tensor it launches the hand-written kernel in
``csrc/slstm_step.cu`` or raises.  On a CPU tensor it runs the plain
version, ``slstm_step_plain``, a loop over time steps doing the same
float32 math.  ``slstm_step_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import library

MAX_HEAD_DIM = 256   # one thread per (output unit, gate pair): 2 * D <= 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def slstm_step_plain(gates, rz, ri, rf, ro):
    """The kernel's function in plain PyTorch: float32 state and R
    products, one step at a time; the output cast to gates' dtype."""
    b, s, h, d, _ = gates.shape
    g32 = gates.float()
    R = torch.stack([r.float() for r in (rz, ri, rf, ro)], dim=-1)  # h,e,d,4
    c = torch.zeros((b, h, d), device=gates.device)
    n = torch.zeros_like(c)
    m = torch.full_like(c, -1e30)
    hs = torch.zeros_like(c)
    out = []
    for t in range(s):
        pre = g32[:, t] + torch.einsum("bhd,hedg->bheg", hs, R)
        z = torch.tanh(pre[..., 0])
        i_pre = pre[..., 1]
        lf = F.logsigmoid(pre[..., 2])
        m_new = torch.maximum(lf + m, i_pre)
        fg = torch.exp(lf + m - m_new)
        ig = torch.exp(i_pre - m_new)
        c = fg * c + ig * z
        n = torch.clamp(fg * n + ig, min=1e-6)
        hs = torch.sigmoid(pre[..., 3]) * c / n
        m = m_new
        out.append(hs)
    return torch.stack(out, dim=1).to(gates.dtype)


def _lib():
    fn = library("slstm_step").slstm_step_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def slstm_step_scan(gates, rz, ri, rf, ro):
    if gates.device.type == "cpu":
        return slstm_step_plain(gates, rz, ri, rf, ro)
    if gates.device.type != "cuda":
        raise ValueError(f"slstm_step_scan: unsupported device {gates.device}")
    b, s, h, d, four = gates.shape
    rs = (rz, ri, rf, ro)
    if four != 4 or any(r.shape != (h, d, d) for r in rs):
        raise ValueError(f"slstm_step_scan: gates {tuple(gates.shape)}, "
                         f"R {[tuple(r.shape) for r in rs]}")
    if gates.dtype not in _DTYPES or any(r.dtype != gates.dtype for r in rs):
        raise TypeError(f"slstm_step_scan: dtypes {gates.dtype}, "
                        f"{[r.dtype for r in rs]}; takes float32 or "
                        "bfloat16, all alike")
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"slstm_step_scan: head_dim {d} must be a multiple "
                         f"of 16 up to {MAX_HEAD_DIM}")
    if any(r.device != gates.device for r in rs):
        raise ValueError("slstm_step_scan: inputs on different devices")
    if not (gates.is_contiguous() and all(r.is_contiguous() for r in rs)):
        raise ValueError("slstm_step_scan: gates and R must be contiguous")
    if gates.data_ptr() % (2 * gates.element_size()):
        raise ValueError("slstm_step_scan: gates must start on a pair "
                         "boundary (the kernel loads two gates at once)")
    out = torch.empty((b, s, h, d), dtype=gates.dtype, device=gates.device)
    if not out.numel():
        return out
    # scratch for R repacked by the kernel's own first pass
    packed = torch.empty((h, d, d, 4), dtype=gates.dtype, device=gates.device)
    err = _lib()(gates.data_ptr(), rz.data_ptr(), ri.data_ptr(),
                 rf.data_ptr(), ro.data_ptr(), packed.data_ptr(),
                 out.data_ptr(), b, s, h, d, _DTYPES[gates.dtype],
                 torch.cuda.current_stream(gates.device).cuda_stream)
    if err:
        raise RuntimeError(f"slstm_step_scan kernel launch failed: "
                           f"cudaError {err}")
    slstm_step_scan.launches += 1
    return out


slstm_step_scan.launches = 0
