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
  place, in buckets of ``collectives.BUCKET_BYTES``.
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
- a rules plan (``param_policy="rules"`` on two or three mesh axes, the
  dry run's production layout): each leaf is cut on every dim its rules
  place, over "data" (FSDP) and "model" (tensor parallelism) at once.
  The step gathers the "data" cuts just in time as fsdp does, and the
  model computes on its "model" parts as under ``tp``; the batch is cut
  over its axis or tuple of axes (``("pod", "data")``), and a gradient
  is averaged over the batch axes that its gather did not already sum.
  ``running(params)`` is the same context for a prefill.  A decode step
  (``running(params, layout)``) under rules that leave the batch whole
  gathers none of the weight matrices' "embed" cuts: every rank runs the
  same rows, so the model splits those dots' contraction over "data"
  instead (``context.contract_for``), as GSPMD does; only a norm's
  scale is still made whole.

The gradient clip needs the norm of the whole gradient: each rank's sum
of squares over its sharded leaves is all-reduced over the axes they are
cut on, and a replicated leaf is counted once.  The metrics are global
values on every rank.  An axis of one rank cuts nothing, and in a group
of one rank every collective is a copy, so a step computes what the
no-group step computes, bit for bit.  A checkpoint's full tree is
gathered onto rank 0's host one leaf at a time (``full_state``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import spans
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.params import (init_params, tree_leaves_with_paths, tree_map,
                             tree_map_with_path)
from ..models.transformer import model_spec
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state
from ..train.steps import _grads, lm_loss, make_train_step
from . import collectives as C
from .base import Plan
from .context import axis_rules, param_gather, state_layout
from .fsdp import ParamGather
from .pipeline import pipeline_grads
from .shardings import (axis_names, cut, cut_tree, cuts, param_pspec,
                        param_shardings, placement_leaves)

SINGLE_DEVICE_TECHNIQUES = ("ddp", "remat-offload")
# the logical axes whose cut over "model" the model computes on (tensor
# parallelism: heads, kv heads, ffn columns, experts, vocab rows, rnn
# channels)
TP_LOGICAL_AXES = ("heads", "kv_heads", "ffn", "experts", "vocab", "rnn")


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
                 device="cuda", group=None, opts: Optional[dict] = None):
        self.cfg, self.plan, self.opt_cfg = cfg, plan, opt_cfg
        self.opts = opts
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
        if plan.technique == "gpipe" and (
                len(cfg.layer_plan()) != 1
                or cfg.layer_plan()[0][0] != "scan"):
            raise ValueError(f"gpipe needs one scanned layer group "
                             f"({cfg.name}: {cfg.layer_plan()})")
        self.device = group.device
        self.sizes = logical_sizes(cfg)
        self._layout(plan)
        self.mesh = group.mesh(plan.mesh_axes, flat=self._flat)
        self.axis = self.mesh.axis(self.names[0]) \
            if len(self.names) == 1 else None
        self.world = self.mesh.axis(self.names)

    def _layout(self, plan: Plan) -> None:
        """Each leaf's placement; the dim that the step gathers (a cut
        over any axis but the one the model computes on: "model" under
        the rules policy, "stage" under gpipe's); the axes its gradient
        is all-reduced over and what it is divided by; the axes its
        squares are summed over for the norm."""
        self.names = plan.mesh_axis_names
        mesh_sizes = dict(plan.mesh_axes)
        size = lambda axes: math.prod(mesh_sizes[a] for a in axes)
        ordered = lambda axes: tuple(a for a in self.names if a in axes)
        local = {"rules": ("model",), "stage": ("stage",)}.get(
            plan.param_policy, ())
        self.rules = dict(plan.rules)
        batch = self.rules.get("batch")
        self.batch_axes = ordered(axis_names(batch)) if batch else ()
        if "model" in self.batch_axes and any(
                self.rules.get(a) == "model" for a in TP_LOGICAL_AXES) \
                and mesh_sizes.get("model", 1) > 1:
            raise NotImplementedError(
                f"rules {self.rules}: the batch and tensor parallelism "
                "on one axis")
        self.p_sh = param_shardings(self.spec_tree, plan)
        self._placement: Dict[tuple, tuple] = {}
        self._dims: List[Optional[int]] = []     # the gathered dim
        # the gathered dim of each leaf that a decode with the batch
        # whole leaves in place: a weight matrix's "embed"
        self._in_place_dims: List[Optional[int]] = []
        self._cut_axes: List[tuple] = []         # every axis a leaf is cut on
        self._reduce_axes: List[tuple] = []      # its gradient's all-reduce
        self._divisor: List[int] = []
        gather_axes = set()
        flat = {self.names, self.batch_axes}
        for path, spec in tree_leaves_with_paths(self.spec_tree):
            ps = param_pspec(spec, plan)
            cs = cuts(ps)
            for d, m in cs:
                if spec.shape[d] % size(axis_names(m)):
                    raise ValueError(
                        f"{'/'.join(path)} {spec.shape}: dim {d} does not "
                        f"split over {m}")
                flat.add(axis_names(m))
            gathered = [(d, m) for d, m in cs if m not in local]
            if len(gathered) > 1:
                raise NotImplementedError(
                    f"{'/'.join(path)} {ps}: the port gathers one dim")
            g_axes = axis_names(gathered[0][1]) if gathered else ()
            if gathered:
                gather_axes.add(gathered[0][1])
            cut_axes = ordered({a for _, m in cs for a in axis_names(m)})
            reduce_axes = tuple(a for a in self.batch_axes
                                if a not in g_axes)
            self._placement[path] = ps
            self._dims.append(gathered[0][0] if gathered else None)
            matrix = sum(a != "layers" for a in spec.axes) > 1
            self._in_place_dims.append(
                None if gathered and matrix
                and spec.axes[gathered[0][0]] == "embed"
                else self._dims[-1])
            self._cut_axes.append(cut_axes)
            self._reduce_axes.append(reduce_axes)
            self._divisor.append(size(self.batch_axes) * size(
                [a for a in g_axes if a not in self.batch_axes]))
            flat.update((cut_axes, reduce_axes))
        if len(gather_axes) > 1:
            raise NotImplementedError(
                f"cuts gathered over {sorted(map(str, gather_axes))}: the "
                "port gathers over one axis")
        self._gather_axis = gather_axes.pop() if gather_axes else None
        self._flat = sorted(a for a in flat if len(a) > 1)

    # ------------------------------------------------------------ step
    @property
    def step(self):
        """train_step(params, opt_state, batch) -> (params, opt, metrics)
        on the model's plain paths, with the plan's remat."""
        if self._step is None:
            if self.group is None:
                self._step = make_train_step(self.cfg, self.opt_cfg,
                                             opts=self.opts,
                                             remat=self.plan.remat)
            elif self.plan.technique == "gpipe":
                self._step = self._gpipe_step
            else:
                self._step = self._spmd_step
        return self._step

    def _loss(self, params, batch):
        return lm_loss(params, self.cfg, batch, opts=self.opts,
                       remat=self.plan.remat)

    def _gathering(self, leaves, saved=False, in_place=False):
        """The just-in-time gather of the dims that the plan cuts over its
        gather axis (none: a null context); with ``saved``, autograd
        keeps only the rank's part of each whole weight it saves; with
        ``in_place``, the weight matrices' "embed" cuts stay as they
        lie."""
        if self._gather_axis is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        gather = ParamGather(self.mesh.axis(self._gather_axis), leaves,
                             self._in_place_dims if in_place else self._dims)
        stack.enter_context(param_gather(gather))
        if saved:
            stack.enter_context(gather.saved_as_parts())
        return stack

    @contextlib.contextmanager
    def running(self, params, layout=None):
        """This rank's context for the model on its part of ``params``:
        the plan's axis rules and the just-in-time gathers.  A prefill of
        a rules plan is ``prefill_forward`` inside it, a decode step
        ``decode_step`` inside it with ``layout``, the placements of the
        decode state's leaves (``launch.mesh.cache_shardings``), under
        which each leaf is the rank's part (:meth:`shard_state`).  A
        decode step under rules that leave the batch whole keeps the
        weight matrices' "embed" cuts in place and splits their dots'
        contraction (``context.contract_for``)."""
        if layout is not None:
            self.flatten_layout(layout)
        in_place = layout is not None and self.rules.get("batch") is None
        with axis_rules(self.rules, self.mesh, self.sizes, in_place), \
                state_layout(layout), \
                self._gathering(_leaves(params), in_place=in_place):
            yield

    def flatten_layout(self, layout) -> None:
        """Make each tuple of axes that ``layout`` names one axis of the
        mesh (in flatten order, the same on every rank); a tuple made
        before is kept."""
        for _, pl in placement_leaves(layout):
            for m in pl:
                if isinstance(m, tuple):
                    self.mesh.flatten(m)

    def shard_state(self, state, layout):
        """This rank's part of a whole decode state under ``layout``
        (``launch.mesh.cache_shardings``; ``pos`` stays as it is)."""
        self.flatten_layout(layout)
        return tree_map(lambda t, pl: cut(t, pl, self.mesh), state, layout)

    def _spmd_step(self, params, opt_state, batch):
        def loss(leaves, batch):
            with self._gathering(_leaves(leaves), saved=not self.plan.remat):
                return self._loss(leaves, batch)

        with spans.span("step"):
            with axis_rules(self.rules, self.mesh, self.sizes):
                grads, metrics = _grads(loss, params, batch)
            g = self._reduce(_leaves(grads))
            if self.batch_axes:
                # the mean of the ranks' metrics over the batch
                axis = self.mesh.axis(self.batch_axes)
                both = C.all_reduce(torch.stack([metrics["loss"],
                                                 metrics["aux_loss"]]),
                                    axis) / axis.size
                metrics = {"loss": both[0], "aux_loss": both[1]}
            return self._update(params, opt_state, g, metrics)

    def _reduce(self, g: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the batch of the ranks' gradients, in place (a
        gathered leaf's gradient is already its part of the sum over the
        gather axis): one bucketed all-reduce for each set of axes."""
        seen = set()
        for i, t in enumerate(g):
            if id(t) in seen:          # one tensor for two leaves
                g[i] = t.clone()
            seen.add(id(g[i]))
        groups: Dict[tuple, List[torch.Tensor]] = {}
        for t, axes in zip(g, self._reduce_axes):
            if axes:
                groups.setdefault(axes, []).append(t)
        for axes, ts in groups.items():
            C.all_reduce_buckets(ts, self.mesh.axis(axes))
        for t, n in zip(g, self._divisor):
            if n != 1:
                t.div_(n)
        return g

    def _gpipe_step(self, params, opt_state, batch):
        with spans.span("step"):
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            ce, aux = pipeline_grads(self.cfg, self.plan.microbatches,
                                     self.axis, leaves, batch)
            g = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for t in _leaves(leaves)]
            # a replicated leaf's gradient is the sum of its stages' parts
            C.all_reduce_buckets([t for t, axes in zip(g, self._cut_axes)
                                  if not axes], self.axis)
            both = C.all_reduce(torch.stack([ce, aux]), self.axis)
            return self._update(params, opt_state, g,
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
        """Norm of the whole gradient: each leaf's squares summed over
        the axes it is cut on (one all-reduce for each set of axes), each
        replicated leaf once; flatten order."""
        parts: Dict[tuple, torch.Tensor] = {}
        whole = 0
        for t, axes in zip(g, self._cut_axes):
            sq = torch.sum(torch.square(t.float()))
            if axes:
                parts[axes] = parts.get(axes, 0) + sq
            else:
                whole = whole + sq
        sharded = 0
        for axes, sq in parts.items():
            sharded = sharded + C.all_reduce(sq, self.mesh.axis(axes))
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
        rows under a plan that shards the batch (over one axis or a tuple
        of axes), else all of it."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        if self.group is None or not self.batch_axes:
            return batch
        axis = self.mesh.axis(self.batch_axes)
        return {k: C.local_slice(v, 0, axis) if v.ndim else v
                for k, v in batch.items()}

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes the job's checkpoints (rank 0)."""
        return self.group is None or self.group.rank == 0

    def _in_root(self, axes) -> bool:
        """Whether this rank shares global rank 0's group of ``axes``."""
        return all(c == 0 for a, c in zip(self.names, self.mesh.coords)
                   if a not in axes)

    def full_state(self, params, opt):
        """{"params", "opt"} with every leaf whole, the tree the
        reference's checkpoint holds.  Without a group: the trees as
        they are.  In a group, every rank takes part and rank 0 gets the
        tree on the host, gathered one leaf at a time over the axes the
        leaf is cut on (a device holds one leaf whole at most); the
        other ranks get None."""
        if self.group is None:
            return {"params": params, "opt": opt}
        writer = self.is_writer
        places = list(self._placement.values())

        def whole(tree):
            out = []
            for t, ps, axes in zip(_leaves(tree), places, self._cut_axes):
                if not axes or not self._in_root(axes):
                    out.append(t.cpu() if writer else None)
                    continue
                axis = self.mesh.axis(axes)
                t = t.contiguous()
                parts = [torch.empty_like(t) for _ in range(axis.size)] \
                    if writer else None
                dist.gather(t, parts, dst=dist.get_global_rank(axis.group, 0),
                            group=axis.group)
                out.append(self._assemble([p.cpu() for p in parts], ps, axes)
                           if writer else None)
                del parts
            return _rebuild(tree, out) if writer else None

        tree = {"params": whole(params),
                "opt": {"mu": whole(opt["mu"]), "nu": whole(opt["nu"]),
                        "step": opt["step"].cpu()}}
        return tree if writer else None

    def _assemble(self, parts, ps, axes):
        """The whole tensor of the ranks' ``parts`` (in the row-major
        order of ``axes``) of a leaf placed by ``ps``."""
        sizes = [self.mesh.size(a) for a in axes]
        shape = list(parts[0].shape)
        for d, m in cuts(ps):
            shape[d] *= self.mesh.size(m)
        full = torch.empty(shape, dtype=parts[0].dtype)
        for idx, part_ in enumerate(parts):
            coords = dict(zip(axes, np.unravel_index(idx, sizes)))
            at = [slice(None)] * len(shape)
            for d, m in cuts(ps):
                block = int(np.ravel_multi_index(
                    [coords[a] for a in axis_names(m)],
                    [self.mesh.size(a) for a in axis_names(m)]))
                k = part_.shape[d]
                at[d] = slice(block * k, (block + 1) * k)
            full[tuple(at)] = part_
        return full

    def cut_array(self, path, arr: np.ndarray) -> np.ndarray:
        """This rank's part of a full checkpoint array at ``path``
        (("params", ...), ("opt", "mu" | "nu", ...) or ("opt", "step"))."""
        if self.group is None or path[:2] == ("opt", "step"):
            return arr
        key = path[1:] if path[0] == "params" else path[2:]
        for d, m in cuts(self._placement.get(tuple(key), ())):
            axis = self.mesh.axis(m)
            k = C.part(arr.shape[d], axis.size)
            arr = np.take(arr, np.arange(axis.rank * k, (axis.rank + 1) * k),
                          axis=d)
        return arr

    def load(self, path: str, params, opt):
        """(params, opt, start_step) from the checkpoint chain at
        ``path``, each rank cutting its part out of the full tree; the
        inputs at step 0 where there is none."""
        from ..checkpoint.store import load_training_state
        return load_training_state(path, params, opt, cut=self.cut_array)
