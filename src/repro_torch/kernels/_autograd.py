"""The kernels' rule on gradients.

The hand-written CUDA kernels compute a forward only: a tensor that a
wrapper returns from a launch has no autograd history.  So while grad
mode is on, each wrapper refuses a CUDA input that requires grad,
rather than cut the graph without a word, until ROADMAP B10 gives the
kernels a backward.  A wrapper calls ``refuse_grad`` on its CUDA branch
only: on the CPU it runs its plain version, which is differentiable.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet (ROADMAP B10); "
            "call it under torch.no_grad() or on inputs that do not "
            "require grad")
