"""``kernel_opts(device)``: the ``opts`` dict that wires the port's
kernels into the model layer.  On CUDA the full-sequence attention,
RG-LRU scan, mLSTM and sLSTM go through the hand-written kernels; on the CPU the
dict is empty and the model runs its plain paths.
"""
from __future__ import annotations

from ..device import resolve_device
from .flash_attention import flash_attention
from .mlstm_chunk import mlstm_chunk
from .rglru_scan import rglru_scan
from .slstm_step import slstm_step_scan

__all__ = ["flash_attention", "rglru_scan", "mlstm_chunk", "slstm_step_scan",
           "kernel_opts"]


def kernel_opts(device="cuda") -> dict:
    if resolve_device(device).type == "cuda":
        return {"attn_fn": flash_attention, "rglru_scan": rglru_scan,
                "mlstm_fn": mlstm_chunk, "slstm_fn": slstm_step_scan}
    return {}
