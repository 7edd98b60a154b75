"""Chunkwise-parallel mLSTM forward (xLSTM matrix memory).

``mlstm_chunk(q, k, v, i_pre, f_pre)`` has the signature of the JAX
package's Pallas kernel: q, k, v (B, S, H, D), i_pre and f_pre (B, S, H)
pre-activations; out (B, S, H, D) in q's dtype, all math in float32.
q is scaled by D**-0.5 inside, as in ``mlstm_parallel_ref``.

On a CUDA tensor it launches the hand-written kernel in
``csrc/mlstm_chunk.cu`` or raises.  On a CPU tensor it runs the plain
version, ``mlstm_chunk_plain``: the port's chunked form in float32 at
the kernel's chunk size.  ``mlstm_chunk.launches`` counts kernel
launches.  Any S is taken: a ragged last chunk is masked.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import library
from .ref import mlstm_chunked_ref

CHUNK = 64          # the kernel's chunk length
MAX_HEAD_DIM = 512  # the kernel keeps a (D, 64) float32 slice of C on chip
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mlstm_chunk_plain(q, k, v, i_pre, f_pre):
    """The kernel's function in plain PyTorch: the chunked form in
    float32 at chunk ``CHUNK``, the output cast to q's dtype.  A ragged
    tail is padded with steps that neither write (i = -inf) nor decay
    (f = +inf), and dropped."""
    s = q.shape[1]
    chunk = min(CHUNK, s)
    pad = -s % chunk
    seq = lambda x, value=0.0: F.pad(x.float(), (0, 0) * (x.ndim - 2)
                                     + (0, pad), value=value)
    out = mlstm_chunked_ref(seq(q), seq(k), seq(v),
                            seq(i_pre, float("-inf")),
                            seq(f_pre, float("inf")), chunk=chunk)
    return out[:, :s].to(q.dtype)


def _lib():
    fn = library("mlstm_chunk").mlstm_chunk_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mlstm_chunk(q, k, v, i_pre, f_pre):
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, i_pre, f_pre)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk: unsupported device {q.device}")
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or \
            i_pre.shape != (b, s, h) or f_pre.shape != (b, s, h):
        raise ValueError(f"mlstm_chunk: q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}, i {tuple(i_pre.shape)}, "
                         f"f {tuple(f_pre.shape)}")
    ts = (q, k, v, i_pre, f_pre)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"mlstm_chunk: dtypes {[t.dtype for t in ts]}; "
                        "takes float32 or bfloat16, all alike")
    if d % 32 or d > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_chunk: head_dim {d} must be a multiple of "
                         f"32 up to {MAX_HEAD_DIM}")
    if any(t.device != q.device for t in ts):
        raise ValueError("mlstm_chunk: inputs on different devices")
    # every input is read by strides in its own layout; q, k and v by
    # 4-wide vector loads (a unit-stride head dim, a 16-byte start and
    # strides in multiples of 4)
    if any(t.stride(-1) != 1 or t.data_ptr() % 16 or
           any(st % 4 for st in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError("mlstm_chunk: q, k and v need a unit-stride head "
                         "dim, a 16-byte aligned start and strides in "
                         "multiples of 4")
    strides = (ctypes.c_longlong * 15)(*(st for t in ts
                                         for st in t.stride()[:3]))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if not out.numel():
        return out
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
                 f_pre.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
                 b, s, h, d, d ** -0.5, _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mlstm_chunk kernel launch failed: cudaError {err}")
    mlstm_chunk.launches += 1
    return out


mlstm_chunk.launches = 0
