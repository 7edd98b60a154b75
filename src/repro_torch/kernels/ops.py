"""``kernel_opts(device)``: the ``opts`` dict that wires the port's
kernels into the model layer.  On CUDA the full-sequence attention goes
through the hand-written flash-attention kernel; on the CPU the dict is
empty and the model runs its plain paths.
"""
from __future__ import annotations

from ..device import resolve_device
from .flash_attention import flash_attention

__all__ = ["flash_attention", "kernel_opts"]


def kernel_opts(device="cuda") -> dict:
    if resolve_device(device).type == "cuda":
        return {"attn_fn": flash_attention}
    return {}
