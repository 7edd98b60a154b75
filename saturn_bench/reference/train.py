"""The reference's first training steps and the numbers read from them.

AdamW as the configuration states it: the gradient clipped to
``grad_clip`` by its global norm; ``mu = b1 mu + (1 - b1) g`` and
``nu = b2 nu + (1 - b2) g^2``; the update ``(mu / (1 - b1^t)) /
(sqrt(nu / (1 - b2^t)) + eps)``; ``p -= lr_t (update + weight_decay *
p)`` on every leaf.  The learning rate warms up linearly over
``warmup_steps`` (``lr (t + 1) / warmup``) and then follows the
schedule (cosine, linear or constant) down to ``total_steps``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

from . import model, params as P


def lr_at(opt: dict, step: int) -> float:
    warm = min((step + 1) / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    decay = {"cosine": 0.5 * (1.0 + math.cos(math.pi * frac)),
             "linear": 1.0 - frac}.get(opt["schedule"], 1.0)
    return opt["lr"] * warm * decay


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in float32 (the default and the configuration's
    precision), or in TF32 for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                         for n in names]).tolist()
    return dict(zip(names, norms))


def change_norms(cfg: dict, seed: int, now: Dict[str, torch.Tensor]
                 ) -> Dict[str, float]:
    """||now - start|| of each leaf, the start drawn again from the seed
    one leaf at a time."""
    out = {}
    for path, start in P.iter_init(cfg, seed, next(iter(now.values())).device):
        out[path] = float(torch.linalg.vector_norm(now[path] - start))
        del start
    return out


def run(cfg: dict, opt: dict, batches: List[torch.Tensor], seed: int,
        device, tf32: bool = False) -> dict:
    """The reference's steps on ``batches`` (one (B, S) token tensor a
    step) from the seed's weights: each step's cross-entropy, the norm
    of each leaf's first gradient as the optimizer takes it (clipped;
    ``mu / (1 - b1)`` after one step) and of each leaf's change after
    the last step."""
    with matmul_precision(tf32):
        params = {k: t.requires_grad_(True)
                  for k, t in P.iter_init(cfg, seed, device)}
        names = list(params)
        mu = {k: torch.zeros_like(t) for k, t in params.items()}
        nu = {k: torch.zeros_like(t) for k, t in params.items()}
        losses, first = [], None
        for step, tokens in enumerate(batches):
            total, ce = model.loss(params, cfg, tokens)
            grads = torch.autograd.grad(total, [params[n] for n in names])
            losses.append(float(ce.detach()))
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(opt["grad_clip"] / gnorm, max=1.0) \
                    if opt["grad_clip"] > 0 else 1.0
                lr = lr_at(opt, step)
                bc1 = 1.0 - opt["b1"] ** (step + 1)
                bc2 = 1.0 - opt["b2"] ** (step + 1)
                for n, g in zip(names, grads):
                    g = g * scale
                    mu[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                    nu[n].mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
                    upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2)
                                           + opt["eps"])
                    p = params[n]
                    p.sub_(lr * (upd + opt["weight_decay"] * p))
            del grads
            if step == 0:
                first = {n: v / (1 - opt["b1"])
                         for n, v in leaf_norms(mu).items()}
        del mu, nu
        now = {k: t.detach() for k, t in params.items()}
        return {"losses": losses, "grad_norms": first,
                "change_norms": change_norms(cfg, seed, now)}
