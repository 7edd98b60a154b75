"""Causal GQA flash attention with an optional sliding window.

``flash_attention(q, k, v, window=0)`` has the signature of the JAX
package's Pallas kernel: q (B, S, H, D) pre-scaled, k and v (B, S, Kv, D),
out (B, S, H, D) in q's dtype; query head h reads kv head h // (H // Kv).

On a CUDA tensor it launches the hand-written kernel in
``csrc/flash_attention.cu`` (the bf16 kernel at D <= 128 takes its
counters from ``workspace``) or raises.  On a CPU tensor
it runs the plain version, ``flash_attention_plain``, which computes the
same function in float32.  ``flash_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._autograd import refuse_grad
from ._build import library
from .ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supports_head_dim(d: int) -> bool:
    """The head dims the kernels take: multiples of 8 (rows of whole
    16-byte units, as TMA needs) from 32 to 256 (wgmma's widest n).  The
    bf16 kernel pads D to whole 64-column boxes, the fp32 one to a
    multiple of 64, both with zeros."""
    return d % 8 == 0 and 32 <= d <= 256


def flash_attention_plain(q, k, v, window: int = 0):
    """The kernel's function in plain PyTorch: float32 throughout, the
    output cast to q's dtype."""
    return attention_ref(q.float(), k.float(), v.float(), window).to(q.dtype)


def _lib():
    lib = library("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return fn


_WORKSPACES = {}


def workspace(q, stream):
    """The kernel's scratch for q on ``stream``: at bf16 and D <= 128 two
    int32 counters of the persistent kernel, zeroed once and left at zero
    by every launch, so each stream keeps its own; else None."""
    if q.dtype != torch.bfloat16 or q.shape[-1] > 128:
        return None
    key = (q.device, stream.cuda_stream)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = torch.zeros(2, dtype=torch.int32,
                                            device=q.device)
    return ws


def _aligned(x):
    """Contiguous with a 16-byte-aligned start (TMA and vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q, k, v, window: int = 0):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    refuse_grad("flash_attention", q, k, v)
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if k.shape != (b, s, kvh, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; takes float32 or bfloat16")
    if not supports_head_dim(d):
        raise ValueError(f"flash_attention: head_dim {d} is not a multiple "
                         "of 8 from 32 to 256")
    if kvh == 0 or h % kvh or window < 0:
        raise ValueError(f"flash_attention: heads {h}/{kvh}, window {window}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v on different devices")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device)
    ws = workspace(q, stream)
    fn = _lib()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, s, h, kvh, d, int(window), _DTYPES[q.dtype],
             stream.cuda_stream, None if ws is None else ws.data_ptr())
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
