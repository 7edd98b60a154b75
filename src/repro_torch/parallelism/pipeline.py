"""GPipe over the "stage" mesh axis, the JAX package's
``parallelism/pipeline.py`` on a process group: a hand-written
all-forward / all-backward schedule with activations and their
gradients passed between neighbouring stages by ``send`` / ``recv``.

Layout contract (``GPipe.search_space``): the model has a single
scanned layer group whose repeat count divides by the stage count;
stacked layer params are sharded over "stage" along the layer axis, so
each rank holds its stage's contiguous repeats.  The embedding, final
norm and unembedding are replicated.

The batch is replicated and cut into ``plan.microbatches`` microbatches
of contiguous rows (the reference's ``x.reshape(M, b // M, s, d)``).
Stage 0 embeds, the last stage runs the final norm, the unembedding and
the cross-entropy over the whole batch (``_ce_from_logits``), and the
aux loss is the sum over stages of each stage's aux, divided by M.  A
replicated leaf gets gradient on every stage that uses it (the
embedding on the first, the head and a tied embedding on the last);
``BuiltJob`` sums those parts across the stages.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.layers import rmsnorm
from ..models.params import tree_leaves_with_paths, tree_map
from ..models.transformer import _block_apply, embed_inputs, unembed
from .dist import Axis


def stage_forward(cfg: ModelConfig, stage_params, x):
    """Apply this stage's repeats (r, ...) of the block pattern."""
    pattern = cfg.layer_plan()[0][1]
    reps = next(tree_leaves_with_paths(stage_params))[1].shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(reps):
        for i, kind in enumerate(pattern):
            p = tree_map(lambda t, r=r: t[r], stage_params[f"pos{i}_{kind}"])
            x, _, a = _block_apply(p, x, kind=kind, cfg=cfg)
            aux = aux + a
    return x, aux


def _seq_len(batch) -> int:
    return sum(batch[k].shape[1] for k in ("embeds", "tokens")
               if batch.get(k) is not None)


def pipeline_grads(cfg: ModelConfig, microbatches: int, axis: Axis, leaves,
                   batch):
    """One GPipe forward and backward of the loss over ``batch``.

    ``leaves`` is this stage's parameter tree of leaves that require
    grad; their ``.grad`` holds this stage's gradient afterwards.
    Returns (ce, aux): the cross-entropy on the last stage (zero on the
    others) and this stage's aux over its microbatches, divided by M."""
    from ..train.steps import _ce_from_logits
    stages, s = axis.size, axis.rank
    M = microbatches
    b = next(v for v in batch.values() if v is not None).shape[0]
    if b % M:
        raise ValueError(f"batch {b} not divisible by microbatches {M}")
    mb = b // M
    peer = lambda k: dist.get_global_rank(axis.group, k)
    embed = leaves["embed"]
    shape = (mb, _seq_len(batch), cfg.d_model)
    ins, outs, auxs = [], [], []
    with torch.enable_grad():
        if s == 0:
            x = embed_inputs(leaves, cfg, batch)
            x_mb = x.detach().reshape((M,) + shape)
        for m in range(M):
            if s == 0:
                inp = x_mb[m].clone()
            else:
                inp = torch.empty(shape, dtype=embed.dtype,
                                  device=embed.device)
                dist.recv(inp, peer(s - 1), group=axis.group)
            inp.requires_grad_(True)
            out, a = stage_forward(cfg, leaves["groups"][0], inp)
            if s < stages - 1:
                dist.send(out.detach().contiguous(), peer(s + 1),
                          group=axis.group)
            ins.append(inp)
            outs.append(out)
            auxs.append(a)
        ce = torch.zeros((), dtype=torch.float32, device=embed.device)
        if s == stages - 1:
            head_in = [o.detach().requires_grad_(True) for o in outs]
            h = rmsnorm(leaves["final_norm"], torch.cat(head_in),
                        cfg.norm_eps)
            loss, _ = _ce_from_logits(cfg, unembed(leaves, cfg, h), batch)
            loss.backward()
            ce = loss.detach()
        inv_m = torch.full((), 1.0 / M, dtype=torch.float32,
                           device=embed.device)
        for m in reversed(range(M)):
            if s == stages - 1:
                g = head_in[m].grad
            else:
                g = torch.empty(shape, dtype=embed.dtype,
                                device=embed.device)
                dist.recv(g, peer(s + 1), group=axis.group)
            pairs = [(outs[m], g)]
            if auxs[m].requires_grad:
                pairs.append((auxs[m], inv_m))
            torch.autograd.backward([t for t, _ in pairs],
                                    [g_ for _, g_ in pairs])
            if s > 0:
                dist.send(ins[m].grad.contiguous(), peer(s - 1),
                          group=axis.group)
        if s == 0 and x.requires_grad:
            x.backward(torch.cat([i.grad for i in ins]).reshape(x.shape))
    aux = sum(a.detach() for a in auxs) / M
    return ce, aux
