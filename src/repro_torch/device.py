"""Device resolution shared by the port's entry points.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``.  Asking for CUDA on a machine without a card raises here:
the port never drifts to the CPU on its own.  Tests pass ``"cpu"``.
"""
from __future__ import annotations

from typing import List

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def local_devices(device="cuda") -> List[torch.device]:
    """The devices a scheduler may place work on: every card for a bare
    ``"cuda"``, else the one device named.  Raises as
    :func:`resolve_device` does without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]
