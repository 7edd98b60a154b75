"""Device resolution shared by the port's entry points.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``.  Asking for CUDA on a machine without a card raises here:
the port never drifts to the CPU on its own.  Tests pass ``"cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev
