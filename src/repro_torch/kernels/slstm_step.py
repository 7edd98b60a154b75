"""sLSTM recurrence forward (xLSTM scalar memory).

``slstm_step_scan(gates, rz, ri, rf, ro)`` has the signature of the JAX
package's Pallas kernel: gates (B, S, H, D, 4) pre-activations (z, i, f,
o, biases included), rz, ri, rf, ro (H, D, D) recurrent weights as
R[h, out, in]; out: the h sequence (B, S, H, D) in gates' dtype.  The
state c, n, m and h is float32 throughout, as are the R products.

On a CUDA tensor it launches a hand-written kernel in
``csrc/slstm_step.cu`` or raises: a thread-block cluster per recurrence,
on the tensor cores for bfloat16 (a cluster of ``mma_cluster(D)`` CTAs
per head and 4 batch rows) and on fp32 FMAs for float32 (a cluster per
batch row and head, split as ``cluster_split(D)`` says).  On a CPU
tensor it runs the plain version, ``slstm_step_plain``, a loop over time
steps doing the same float32 math.  ``slstm_step_scan.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._autograd import refuse_grad
from ._build import library

MAX_HEAD_DIM = 256
R_REGISTERS = 36864   # fp32: 32-bit registers a CTA gives its slice of R
MMA_THREADS = 256     # bf16: the most threads a CTA has (8 units a warp)
_DTYPES = (torch.float32, torch.bfloat16)


class ClusterSplit(NamedTuple):
    """How the fp32 kernel splits one (batch row, head) over a cluster."""
    cluster: int    # CTAs in the cluster
    parts: int      # lanes that share one output unit's four rows of R
    chunks: int     # chunks of 4 d values each lane holds
    units: int      # output units (all four gates of each) a CTA owns
    threads: int    # threads of a CTA: units * parts

    @property
    def r_registers(self) -> int:
        """32-bit registers a CTA holds R in (fp32, padding included)."""
        return self.threads * 4 * 4 * self.chunks


def _check_head_dim(d: int) -> None:
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"slstm_step_scan: head_dim {d} must be a multiple "
                         f"of 16 up to {MAX_HEAD_DIM}")


def cluster_split(d: int) -> ClusterSplit:
    """The fp32 kernel's split for head dim ``d``: the fewest CTAs (a power
    of two, at most 8, the portable cluster size) whose slices of the four
    D x D matrices, as fp32 in registers, stay within ``R_REGISTERS``
    each; the inner dimension split over P lanes of at most 6 chunks of 4
    (96 registers a lane)."""
    _check_head_dim(d)
    cluster = 1
    while 4 * d * d > cluster * R_REGISTERS:
        cluster *= 2
    parts = 4 if d <= 96 else 8 if d <= 192 else 16
    chunks = -(-d // (4 * parts))
    units = d // cluster
    return ClusterSplit(cluster, parts, chunks, units, units * parts)


def mma_cluster(d: int) -> int:
    """The bf16 kernel's cluster size for head dim ``d``: the fewest CTAs
    (1, 2 or 4) that keep a CTA at ``MMA_THREADS`` or fewer, one warp per
    8 of its D / C output units (the last warp padded)."""
    _check_head_dim(d)
    cluster = 1
    while 32 * -(-(d // cluster) // 8) > MMA_THREADS:
        cluster *= 2
    return cluster


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


def _fn(name: str, n_ints: int):
    fn = getattr(library("slstm_step"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_ints + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def slstm_step_scan(gates, rz, ri, rf, ro):
    if gates.device.type == "cpu":
        return slstm_step_plain(gates, rz, ri, rf, ro)
    if gates.device.type != "cuda":
        raise ValueError(f"slstm_step_scan: unsupported device {gates.device}")
    refuse_grad("slstm_step_scan", gates, rz, ri, rf, ro)
    b, s, h, d, four = gates.shape
    rs = (rz, ri, rf, ro)
    if four != 4 or any(r.shape != (h, d, d) for r in rs):
        raise ValueError(f"slstm_step_scan: gates {tuple(gates.shape)}, "
                         f"R {[tuple(r.shape) for r in rs]}")
    if gates.dtype not in _DTYPES or any(r.dtype != gates.dtype for r in rs):
        raise TypeError(f"slstm_step_scan: dtypes {gates.dtype}, "
                        f"{[r.dtype for r in rs]}; takes float32 or "
                        "bfloat16, all alike")
    _check_head_dim(d)
    if any(r.device != gates.device for r in rs):
        raise ValueError("slstm_step_scan: inputs on different devices")
    if not (gates.is_contiguous() and all(r.is_contiguous() for r in rs)):
        raise ValueError("slstm_step_scan: gates and R must be contiguous")
    if any(x.data_ptr() % (4 * x.element_size()) for x in (gates, *rs)):
        raise ValueError("slstm_step_scan: gates and R must start on a "
                         "4-element boundary (the kernel loads four at once)")
    out = torch.empty((b, s, h, d), dtype=gates.dtype, device=gates.device)
    if not out.numel():
        return out
    ptrs = [x.data_ptr() for x in (gates, *rs, out)]
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    if gates.dtype == torch.bfloat16:
        err = _fn("slstm_step_bf16", 5)(*ptrs, b, s, h, d, mma_cluster(d),
                                        stream)
    else:
        split = cluster_split(d)
        err = _fn("slstm_step_f32", 7)(*ptrs, b, s, h, d, split.cluster,
                                       split.parts, split.chunks, stream)
    if err:
        raise RuntimeError(f"slstm_step_scan kernel launch failed: "
                           f"cudaError {err}")
    slstm_step_scan.launches += 1
    return out


slstm_step_scan.launches = 0
