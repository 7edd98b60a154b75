"""RG-LRU linear recurrence (Griffin / RecurrentGemma temporal mixing).

``rglru_scan(a, b)`` has the signature of the JAX package's Pallas
kernel: a and b (B, S, R); out h (B, S, R) in a's dtype, with
h_t = a_t h_{t-1} + b_t and h_0 = 0.  The carry is float32.

On a CUDA tensor it launches the hand-written kernel in
``csrc/rglru_scan.cu`` or raises.  On a CPU tensor it runs the plain
version, ``rglru_scan_plain``, which computes the same function with a
float32 carry.  ``rglru_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._autograd import refuse_grad
from ._build import library
from .ref import rglru_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan_plain(a, b):
    """The kernel's function in plain PyTorch: the scan in float32, the
    output cast to a's dtype."""
    return rglru_scan_ref(a.float(), b.float()).to(a.dtype)


def _lib():
    fn = library("rglru_scan").rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rglru_scan(a, b):
    if a.device.type == "cpu":
        return rglru_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    refuse_grad("rglru_scan", a, b)
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"rglru_scan: dtypes {a.dtype}, {b.dtype}; takes "
                        "float32 or bfloat16, both alike")
    if b.device != a.device:
        raise ValueError("rglru_scan: a and b on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous")
    bsz, s, r = a.shape
    out = torch.empty_like(a)
    if not out.numel():
        return out
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, r,
                 _DTYPES[a.dtype],
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
