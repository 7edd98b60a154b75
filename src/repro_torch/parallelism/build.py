"""Turn a (model config, Plan) pair into an executable: parameters and
optimizer state on a device, and a train step.  Used by the Trial
Runner (profiling), the backends (real runs) and the launch path.

Without a process group a ``BuiltJob`` runs one device: ``ddp`` and
``remat-offload`` at n = 1 (remat-offload's ``param_policy="fsdp"``
over one device is replication).  With a group
(:func:`~repro_torch.parallelism.dist.init_group`) of ``plan.n_devices``
ranks it runs the plan's technique as one rank of the job:

- ``ddp``: replicated parameters; each rank takes its contiguous slice
  of the global batch, and the gradients are averaged across ranks in
  one flat all-reduce a dtype.
- ``fsdp``, and ``remat-offload`` at n > 1: parameters and AdamW's mu
  and nu rest sharded on ``param_pspec``'s axis (a leaf with no
  divisible axis is replicated).  The step makes each unit's parameters
  whole just in time, one repeat of a scanned group at a time, and its
  backward reduce-scatters each unit's gradients
  (:mod:`~repro_torch.parallelism.fsdp`); the rank updates only its
  parts.
- ``tp``: the parameters rest sharded by ``plan.rules`` over "model";
  the batch is replicated and the model's blocks split their work under
  ``axis_rules`` (``models.layers``, ``moe``, ``recurrent``; for an MoE
  config this is expert parallelism).
- ``gpipe``: :mod:`~repro_torch.parallelism.pipeline`.

The gradient clip needs the norm of the whole gradient: each rank's sum
of squares over its sharded leaves is all-reduced, and a replicated leaf
is counted once.  The metrics are global values on every rank.  In a
group of one rank every collective is a copy, so a step computes what
the no-group step computes, bit for bit.  A checkpoint's full tree is
gathered onto rank 0's host one leaf at a time (``full_state``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.params import (init_params, tree_leaves_with_paths, tree_map,
                             tree_map_with_path)
from ..models.transformer import model_spec
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state
from ..train.steps import _grads, lm_loss, make_train_step
from . import collectives as C
from .base import Plan
from .context import axis_rules, param_gather
from .fsdp import ParamGather
from .pipeline import pipeline_grads
from .shardings import cut_tree, param_pspec, param_shardings, sharded_dim

SINGLE_DEVICE_TECHNIQUES = ("ddp", "remat-offload")


def logical_sizes(cfg: ModelConfig) -> Dict[str, int]:
    """Global sizes of the logical axes the model cuts in place
    (``context.shard``)."""
    sizes = {"vocab": cfg.vocab_size}
    if cfg.is_moe:
        sizes["experts"] = cfg.moe.num_experts
    return sizes


def _leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in tree_leaves_with_paths(tree)]


def _rebuild(tree, leaves: List[torch.Tensor]):
    """``tree`` with its leaves, in flatten order, replaced by ``leaves``."""
    by_path = {p: t for (p, _), t in zip(tree_leaves_with_paths(tree),
                                         leaves)}
    return tree_map_with_path(lambda p, _: by_path[p], tree)


class BuiltJob:
    """Executable artifact for one (model, technique, n_devices) choice,
    on one device or as one rank of the job's process group."""

    def __init__(self, cfg: ModelConfig, plan: Plan, opt_cfg: AdamWConfig,
                 device="cuda", group=None):
        self.cfg, self.plan, self.opt_cfg = cfg, plan, opt_cfg
        self.group = group
        self.spec_tree = model_spec(cfg)
        self._step = None
        self.mesh = None
        if group is None:
            if plan.n_devices > 1:
                raise ValueError(
                    f"{plan.technique} at {plan.n_devices} devices runs as "
                    f"{plan.n_devices} ranks of a process group: pass the "
                    "rank's group (parallelism.dist.init_group)")
            if plan.technique not in SINGLE_DEVICE_TECHNIQUES:
                raise ValueError(f"technique {plan.technique!r} needs more "
                                 "than one device")
            self.device = resolve_device(device)
            return
        if group.size != plan.n_devices:
            raise ValueError(f"{plan.technique} x{plan.n_devices} in a "
                             f"group of {group.size} ranks")
        if len(plan.mesh_axes) != 1:
            raise NotImplementedError(
                f"mesh {plan.mesh_axes}: the port runs one mesh axis")
        self.device = group.device
        self.mesh = group.mesh(plan.mesh_axes)
        self.axis = self.mesh.axis(plan.mesh_axis_names[0])
        self.sizes = logical_sizes(cfg)
        self.p_sh = param_shardings(self.spec_tree, plan)
        self._placement = {}
        self._dims: List[Optional[int]] = []
        for path, spec in tree_leaves_with_paths(self.spec_tree):
            ps = param_pspec(spec, plan)
            sd = sharded_dim(ps)
            if sd is not None and spec.shape[sd[0]] % self.axis.size:
                raise ValueError(
                    f"{'/'.join(path)} {spec.shape}: dim {sd[0]} does not "
                    f"split over {self.axis.size} ranks")
            self._placement[path] = sd
            self._dims.append(None if sd is None else sd[0])
        self._sharded = [i for i, d in enumerate(self._dims) if d is not None]
        self._whole = [i for i, d in enumerate(self._dims) if d is None]
        if plan.technique == "gpipe" and (
                len(cfg.layer_plan()) != 1
                or cfg.layer_plan()[0][0] != "scan"):
            raise ValueError(f"gpipe needs one scanned layer group "
                             f"({cfg.name}: {cfg.layer_plan()})")

    # ------------------------------------------------------------ step
    @property
    def step(self):
        """train_step(params, opt_state, batch) -> (params, opt, metrics)
        on the model's plain paths, with the plan's remat."""
        if self._step is None:
            if self.group is None:
                self._step = make_train_step(self.cfg, self.opt_cfg,
                                             remat=self.plan.remat)
            elif self.plan.technique == "gpipe":
                self._step = self._gpipe_step
            else:
                self._step = self._spmd_step
        return self._step

    def _loss(self, params, batch):
        return lm_loss(params, self.cfg, batch, remat=self.plan.remat)

    def _spmd_step(self, params, opt_state, batch):
        plan, axis, n = self.plan, self.axis, self.axis.size
        loss = self._loss
        if plan.param_policy == "fsdp":
            def loss(leaves, batch):
                gather = ParamGather(axis, _leaves(leaves), self._dims)
                saved = contextlib.nullcontext() if plan.remat \
                    else gather.saved_as_parts()
                with param_gather(gather), saved:
                    return self._loss(leaves, batch)
        with axis_rules(plan.rules, self.mesh, self.sizes):
            grads, metrics = _grads(loss, params, batch)
        g = _leaves(grads)
        if plan.param_policy in ("replicate", "fsdp"):
            # data parallel: the mean of the ranks' gradients and metrics
            # (an fsdp leaf's gradient is already its part of the sum)
            out = list(g)
            whole = self._whole if plan.param_policy == "fsdp" \
                else range(len(g))
            C.all_reduce_flat(g, whole, axis, out)
            g = [t.div(n) for t in out]
            both = C.all_reduce(torch.stack([metrics["loss"],
                                             metrics["aux_loss"]]), axis) / n
            metrics = {"loss": both[0], "aux_loss": both[1]}
        return self._update(params, opt_state, g, metrics)

    def _gpipe_step(self, params, opt_state, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        ce, aux = pipeline_grads(self.cfg, self.plan.microbatches,
                                 self.axis, leaves, batch)
        g = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in _leaves(leaves)]
        # a replicated leaf's gradient is the sum of its stages' parts
        out = list(g)
        C.all_reduce_flat(g, self._whole, self.axis, out)
        both = C.all_reduce(torch.stack([ce, aux]), self.axis)
        return self._update(params, opt_state, out,
                            {"loss": both[0], "aux_loss": both[1]})

    def _update(self, params, opt_state, g, metrics):
        grads = _rebuild(params, g)
        loss = metrics["loss"]
        metrics = {"loss": loss,
                   "perplexity": torch.exp(torch.clamp(loss, max=20.0)),
                   "aux_loss": metrics["aux_loss"]}
        params, opt_state, om = adamw_update(
            self.opt_cfg, params, grads, opt_state, gnorm=self._norm(g))
        metrics.update(om)
        return params, opt_state, metrics

    def _norm(self, g):
        """Norm of the whole gradient: the sharded leaves' squares summed
        over the ranks, each replicated leaf once; flatten order."""
        sharded, whole = 0, 0
        for t, d in zip(g, self._dims):
            sq = torch.sum(torch.square(t.float()))
            if d is None:
                whole = whole + sq
            else:
                sharded = sharded + sq
        if self._sharded:
            sharded = C.all_reduce(sharded, self.axis)
        return torch.sqrt(sharded + whole)

    # ----------------------------------------------------------- state
    def init(self, seed: int = 0, dtype=torch.float32):
        """Parameters from ``seed`` and a zero optimizer state: the full
        tree is drawn (as on one device) and each rank keeps its part."""
        params = self.shard(init_params(self.spec_tree, seed, dtype,
                                        self.device))
        return params, init_opt_state(params)

    def shard(self, params):
        """This rank's part of a full parameter tree (the tree itself
        without a group)."""
        if self.group is None:
            return params
        return cut_tree(params, self.p_sh, self.mesh)

    def place_batch(self, batch):
        """The batch on this rank's device: its contiguous slice of the
        rows under a plan that shards the batch, else all of it."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        ax = self.plan.rules.get("batch") if self.group is not None else None
        if ax is None:
            return batch
        axis = self.mesh.axis(ax)
        return {k: C.local_slice(v, 0, axis) if v.ndim else v
                for k, v in batch.items()}

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes the job's checkpoints (rank 0)."""
        return self.group is None or self.group.rank == 0

    def full_state(self, params, opt):
        """{"params", "opt"} with every leaf whole, the tree the
        reference's checkpoint holds.  Without a group: the trees as
        they are.  In a group, every rank takes part and rank 0 gets the
        tree on the host, gathered one leaf at a time (a device holds
        one leaf whole at most); the other ranks get None."""
        if self.group is None:
            return {"params": params, "opt": opt}
        axis = self.axis
        writer = axis.rank == 0
        dst = dist.get_global_rank(axis.group, 0)

        def whole(tree):
            out = []
            for t, d in zip(_leaves(tree), self._dims):
                if d is None:
                    out.append(t.cpu() if writer else None)
                    continue
                t = t.contiguous()
                parts = [torch.empty_like(t) for _ in range(axis.size)] \
                    if writer else None
                dist.gather(t, parts, dst=dst, group=axis.group)
                out.append(torch.cat([p.cpu() for p in parts], dim=d)
                           if writer else None)
                del parts
            return _rebuild(tree, out) if writer else None

        tree = {"params": whole(params),
                "opt": {"mu": whole(opt["mu"]), "nu": whole(opt["nu"]),
                        "step": opt["step"].cpu()}}
        return tree if writer else None

    def cut_array(self, path, arr: np.ndarray) -> np.ndarray:
        """This rank's part of a full checkpoint array at ``path``
        (("params", ...), ("opt", "mu" | "nu", ...) or ("opt", "step"))."""
        if self.group is None:
            return arr
        key = path[1:] if path[0] == "params" else path[2:]
        sd = self._placement.get(tuple(key)) if path[:2] != ("opt", "step") \
            else None
        if sd is None:
            return arr
        dim = sd[0]
        k = C.part(arr.shape[dim], self.axis.size)
        return np.take(arr, np.arange(self.axis.rank * k,
                                      (self.axis.rank + 1) * k), axis=dim)

    def load(self, path: str, params, opt):
        """(params, opt, start_step) from the checkpoint chain at
        ``path``, each rank cutting its part out of the full tree; the
        inputs at step 0 where there is none."""
        from ..checkpoint.store import load_training_state
        return load_training_state(path, params, opt, cut=self.cut_array)
