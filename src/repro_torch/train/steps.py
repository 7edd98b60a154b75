"""Training and serving step functions.

``train_step`` — causal-LM loss (next-token CE; audio archs use provided
codec labels; VLM masks the patch prefix), AdamW update, MoE aux loss.
``serve_step`` — single-token decode against a KV/recurrent-state cache.

Training runs the model's plain paths, as the JAX package's does:
``lm_loss`` turns ``opts=None`` into ``{}``, never into the kernels'
``kernel_opts``, whose CUDA kernels have no backward.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import spans
from ..models.config import ModelConfig
from ..parallelism import collectives as C
from ..parallelism.context import tp_for
from ..models.params import tree_leaves_with_paths, tree_map
from ..models.transformer import decode_step, forward
from ..optim.adamw import AdamWConfig, adamw_update


def _ce_from_logits(cfg: ModelConfig, logits, batch):
    """Mean next-token cross-entropy.  Audio archs use provided codec
    labels (aligned); others shift tokens; VLM skips the patch prefix."""
    if cfg.frontend == "audio":
        targets = batch["labels"]
        pred = logits
    else:
        tokens = batch["tokens"]
        n_prefix = logits.shape[1] - tokens.shape[1]  # VLM patch prefix
        pred = logits[:, n_prefix:][:, :-1]
        targets = tokens[:, 1:]
    tp = tp_for("vocab")
    if tp is None:
        logp = F.log_softmax(pred.float(), dim=-1)
        nll = -torch.take_along_dim(logp, targets[..., None].long(),
                                    dim=-1)[..., 0]
    else:
        nll = _vocab_parallel_nll(pred.float(), targets, tp)
    loss = torch.mean(nll)
    return loss, {"loss": loss,
                  "perplexity": torch.exp(torch.clamp(loss, max=20.0))}


def _vocab_parallel_nll(logits, targets, tp):
    """-log softmax(logits)[target] where each rank holds a contiguous
    slice of the vocab: the max, the sum of exponentials and the target's
    logit are each reduced over the ranks (the max without gradient: it
    only steadies the exponentials)."""
    v = logits.shape[-1]
    m = C.all_reduce(logits.detach().amax(-1), tp,
                     op=dist.ReduceOp.MAX)
    z = logits - m[..., None]
    lse = torch.log(C.reduce_out(torch.exp(z).sum(-1), tp))
    local = targets.long() - tp.rank * v
    inside = (local >= 0) & (local < v)
    picked = torch.take_along_dim(z, local.clamp(0, v - 1)[..., None],
                                  dim=-1)[..., 0]
    return lse - C.reduce_out(torch.where(inside, picked, 0.0), tp)


def lm_loss(params, cfg: ModelConfig, batch, *, opts=None, remat=False):
    """Mean next-token cross-entropy (+ MoE aux).  Returns (loss, metrics).
    ``opts=None`` is the plain path (``{}``)."""
    logits, aux = forward(params, cfg, batch, opts=opts or {}, remat=remat)
    with spans.span("head", logits) as out:
        loss, metrics = _ce_from_logits(cfg, logits, batch)
        loss = out(loss)
    metrics["aux_loss"] = aux
    return loss + aux, metrics


def _grads(loss_fn, params, batch):
    """(grads, metrics) of ``loss_fn(params, batch)``: autograd over
    detached leaves, so no ``.grad`` is left on ``params``.  A leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives it."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat = [t for _, t in tree_leaves_with_paths(leaves)]
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(t): torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, gs)}
    grads = tree_map(lambda t: by_id[id(t)], leaves)
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    opts: Optional[dict] = None, remat: bool = False,
                    microbatches: int = 1, loss_fn=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    microbatches > 1 accumulates gradients over batch slices in float32
    (gradient accumulation); the metrics are their means.  The update
    writes the parameters and the optimizer state in place.
    """

    if loss_fn is None:
        def loss_fn(params, batch):
            return lm_loss(params, cfg, batch, opts=opts, remat=remat)

    def train_step(params, opt_state, batch):
        with spans.span("step"):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if microbatches == 1:
            grads, metrics = _grads(loss_fn, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            ms = []
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                g, m = _grads(loss_fn, params, mb)
                tree_map(lambda acc, gi: acc.add_(gi), grads, g)
                ms.append(m)
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        metrics.update(opt_metrics)
        return new_params, new_opt, metrics

    return train_step


def make_serve_step(cfg: ModelConfig, *, opts: Optional[dict] = None):
    """Returns serve_step(params, tokens (B,1), state) ->
    (next_tokens (B,1) greedy, logits, new_state)."""

    @torch.no_grad()
    def serve_step(params, tokens, state):
        logits, new_state = decode_step(params, cfg, tokens, state, opts=opts)
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, logits, new_state

    return serve_step
