"""AdamW and its learning-rate schedules over the port's parameter trees
(nested dicts and lists of tensors), the JAX package's arithmetic.

mu and nu are float32 whatever the parameters' dtype, and ``step`` is
an int32 scalar on the parameters' device, so a checkpoint holds the
same ``opt/step`` as the JAX package's.  The update runs under
``torch.no_grad()`` and writes each parameter and moment in place; it
returns the trees all the same.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.params import tree_leaves_with_paths, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    schedule: str = "cosine"     # constant | cosine | linear
    warmup_steps: int = 100
    total_steps: int = 10000


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor) as a
    float32 tensor: linear warmup over ``warmup_steps``, then the
    schedule's decay to ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def init_opt_state(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = next(iter(tree_leaves_with_paths(params)))[1].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _leaves(tree):
    return [t for _, t in tree_leaves_with_paths(tree)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed over
    the leaves in JAX's flatten order."""
    total = 0
    for x in _leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, gnorm=None):
    """Returns (new_params, new_state, metrics).  ``gnorm`` is the
    global gradient norm where the caller knows it (a sharded job holds
    only its part of the gradient); by default that of ``grads``."""
    step = state["step"]
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    lr = lr_at(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                            _leaves(state["mu"]), _leaves(state["nu"])):
        # JAX scales the gradient by a float32 array, which promotes a
        # bf16 gradient to float32 before it is rounded
        g32 = g.float() if scale is None else g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (update + cfg.weight_decay * p32))
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
