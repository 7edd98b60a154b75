"""Multi-pod dry run: trace one rank's step of every (architecture x
input shape) on the production meshes and record its flops, bytes
written, collectives and memory, the JAX package's
``launch/dryrun.py`` for process groups.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out results/dryrun_torch

The reference lowers and compiles each combination on 256 or 512
placeholder host devices, and GSPMD partitions it from the rules of
:mod:`~repro_torch.launch.mesh`.  The port has no partitioner: a
placement is a one-rank SPMD program (``BuiltJob`` of a rules ``Plan``,
``parallelism/build.py``).  So the dry run traces rank 0 of that very
program through :func:`~repro_torch.launch.step_analysis.analyze_step`,
on ``meta`` tensors, with a fake process group standing in for the
other 255 or 511 ranks: the train function is the ``BuiltJob`` step,
the prefill function ``prefill_forward`` inside the job's ``running``
context.  No card and no memory are needed.

The decode function is ``decode_step`` inside the job's ``running``
context with the state's placements (``mesh.cache_shardings`` under the
``cache_policy``), then the next token's argmax over the rank's vocab
part: one token of each of the rank's rows against its part of every KV
cache and recurrent state.  A decode record counts that one step:
the flops of the projections, the attention over the rank's part of the
caches and the unembedding; as ``bytes_written`` the output of every op,
where the in-place append of one token's k and v counts the whole
mutated cache part, as the reference's ``dynamic-update-slice`` writes
its whole output buffer; as collectives the activations that move (q,
the scores or the softmax statistics, the attention output, one token's
k and v, the recurrent states re-laid); and as ``argument_bytes`` the
parameters, the tokens and the state parts.

Every combination must trace; a failure is a fault of the port's 2-D
program.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from ..configs import ARCH_IDS, get_config, input_specs, shape_supported
from ..models.config import INPUT_SHAPES, InputShape, ModelConfig
from ..models.params import ShapeDtype, param_count, tree_map
from ..models.transformer import model_spec
from ..parallelism.base import Plan
from ..parallelism.build import TP_LOGICAL_AXES
from ..parallelism.shardings import axis_names, local_shape, param_pspec
from .mesh import (activation_rules, cache_shardings, make_production_mesh,
                   mesh_sizes, production_param_rules)


def _rank_batch(batch_specs, sizes, bax):
    """The rows of the global batch that one rank takes."""
    n = math.prod(sizes[a] for a in axis_names(bax)) if bax else 1

    def part(x):
        if not x.shape or n == 1:
            return x
        return ShapeDtype((x.shape[0] // n,) + tuple(x.shape[1:]), x.dtype)
    return {k: part(v) for k, v in batch_specs.items()}


def build_lowerable(cfg: ModelConfig, shape: InputShape, mesh,
                    multi_pod: bool, *, remat: Optional[bool] = None,
                    extra_opts: Optional[dict] = None,
                    rules_override: Optional[dict] = None,
                    param_rules_override: Optional[dict] = None,
                    cache_policy: str = "heads"):
    """Returns (fn, args, plan): ``analyze_step(fn, args,
    world_size=plan.n_devices)`` traces one rank of ``plan`` on ``mesh``
    (a ``mesh_axes`` tuple).  ``args`` are that rank's parts as
    ``ShapeDtype``: the parameters in bf16 and, for train, AdamW's mu
    and nu in fp32, cut by the parameter rules, and its rows of the
    batch (decode: of ``tokens``, (B, 1)), and for decode its part of
    every leaf of the decode state under ``cache_shardings(...,
    policy=cache_policy)``.  One rules dict places both: the activation
    rules with ``rules_override``, and on the axes the parameters are
    cut on (the tensor-parallel ones and "embed") the parameter rules
    with ``param_rules_override``, since the model splits its work
    where the parameters are cut.  A decode ``fn`` returns (the next
    tokens, the new state)."""
    from torch.utils._python_dispatch import _disable_current_modes

    from ..models.transformer import (decode_step, greedy_tokens,
                                      prefill_forward)
    from ..optim.adamw import AdamWConfig
    from ..parallelism.build import BuiltJob
    from .step_analysis import META, current_group

    prules = production_param_rules(cfg, mesh, multi_pod)
    if param_rules_override:
        prules.update(param_rules_override)
        prules = {k: v for k, v in prules.items() if v is not None}
    rules = {**activation_rules(cfg, shape, multi_pod),
             **(rules_override or {})}
    rules.update({a: prules.get(a) for a in TP_LOGICAL_AXES + ("embed",)})
    sizes = mesh_sizes(mesh)
    mesh_axes = tuple(sizes.items())
    train = shape.mode == "train"
    if train and remat is None:
        remat = True  # large-model default: activation checkpointing
    plan = Plan("rules", math.prod(sizes.values()), mesh_axes, rules,
                param_policy="rules", remat=bool(remat))
    opts = extra_opts or {}
    spec_tree = model_spec(cfg)
    part = lambda dtype: tree_map(lambda s: ShapeDtype(
        local_shape(s.shape, param_pspec(s, plan), sizes), dtype), spec_tree)
    params = part(torch.bfloat16)
    batch = _rank_batch(input_specs(cfg, shape), sizes, rules.get("batch"))

    def job(layout=None):
        # built real and uncounted, as rank 0 of the analysis' group,
        # with the axes of the decode state's placements
        with _disable_current_modes():
            built = BuiltJob(cfg, plan, AdamWConfig(), device=META,
                             group=current_group(), opts=opts)
            if layout is not None:
                built.flatten_layout(layout)
            return built

    if train:
        def fn(params, opt_state, batch):
            return job().step(params, opt_state, batch)

        opt = {"mu": part(torch.float32), "nu": part(torch.float32),
               "step": ShapeDtype((), torch.int32)}
        return fn, (params, opt, batch), plan

    if shape.mode == "prefill":
        def fn(params, batch):
            built = job()
            with torch.no_grad(), built.running(params):
                return prefill_forward(params, cfg, batch, opts=opts)
        return fn, (params, batch), plan

    # decode: one token against a seq_len cache
    layout, spec = cache_shardings(cfg, shape, mesh, multi_pod,
                                   policy=cache_policy)
    state = tree_map(lambda s, pl: ShapeDtype(
        local_shape(s.shape, pl, sizes), s.dtype), spec, layout)

    def fn(params, tokens, state):
        built = job(layout)
        with torch.no_grad(), built.running(params, layout):
            logits, new_state = decode_step(params, cfg, tokens, state,
                                            opts=opts)
            return greedy_tokens(logits), new_state
    return fn, (params, batch["tokens"], state), plan


def optimized_overrides(cfg: ModelConfig, shape: InputShape) -> dict:
    """The beyond-paper sharding presets found in EXPERIMENTS.md §Perf.

    - small models (<1B): pure data parallelism over all 256/512 chips
      (TP of a small model is pure overhead), no remat, batched-gradient
      sLSTM.
    - large dense train: FSDP-256 (ZeRO-3 over both axes) instead of
      2-D FSDP x TP — param all-gathers replace per-layer activation
      all-reduces; larger blockwise-attention kv chunks.
    - MoE: keep expert parallelism (experts must shard), FSDP the rest.
    - decode: sequence-sharded KV cache + token-replicated activations
      (weights stay put; tokens move).
    """
    kw: dict = {"extra_opts": {}}
    n_params = param_count(model_spec(cfg))
    small = n_params < 1e9
    if shape.mode == "train":
        if small:
            kw["rules_override"] = {"batch": ("data", "model")}
            kw["param_rules_override"] = {
                "ffn": None, "heads": None, "rnn": None, "vocab": None,
                "embed": None, "kv_heads": None, "experts": None}
            kw["remat"] = False
        elif not cfg.is_moe:
            kw["rules_override"] = {"batch": ("data", "model"),
                                    "vocab": None}
            kw["param_rules_override"] = {
                "heads": None, "kv_heads": None, "ffn": None,
                "rnn": None, "vocab": None}
        # MoE train keeps the expert-parallel 2-D layout (experts must
        # shard over model; embed stays FSDP over data)
        kw["extra_opts"]["slstm_batched_grad"] = True
        if not small:
            kw["extra_opts"]["attn_fn"] = _blockwise_big_chunks
    elif shape.mode == "prefill":
        kw["extra_opts"]["slstm_batched_grad"] = True
        kw["extra_opts"]["attn_fn"] = _blockwise_big_chunks
    else:  # decode
        # sequence-sharded cache wins when kv heads / head_dim cannot
        # shard cleanly; windowed-attention archs (gemma3, recurrent-
        # gemma, danube) measured better with the baseline heads policy
        if cfg.window_size == 0:
            kw["cache_policy"] = "seq"
        if cfg.is_moe or shape.global_batch <= 1:
            kw["rules_override"] = {"batch": None}
    return kw


def _blockwise_big_chunks(q, k, v, w):
    from ..models.blockwise import blockwise_attention
    s = q.shape[1]
    qc = 1024 if s % 1024 == 0 else 512
    kc = 2048 if s % 2048 == 0 else 512
    return blockwise_attention(q, k, v, window=w, q_chunk=qc, kv_chunk=kc)


def _nbytes(tree) -> int:
    from ..models.params import tree_leaves_with_paths
    return sum(math.prod(x.shape) * torch.empty((), dtype=x.dtype)
               .element_size() for _, x in tree_leaves_with_paths(tree))


def run_one(arch: str, shape_name: str, multi_pod: bool, *,
            remat: Optional[bool] = None, extra_opts: Optional[dict] = None,
            rules_override: Optional[dict] = None,
            param_rules_override: Optional[dict] = None,
            cache_policy: str = "heads", preset: str = "baseline",
            peak_top: int = 0, verbose: bool = True) -> dict:
    """One combination's record, with the reference's keys: ``arch``,
    ``shape``, ``mesh``, ``mode``, ``preset``, ``status`` ("ok",
    "skipped" or "fail"), ``flops``, ``bytes_written``, ``collectives``
    (payload bytes by kind, and ``total``), ``wall_s`` and ``memory``:
    ``argument_bytes`` (the rank's parameter, optimizer state, batch
    and decode state bytes) and ``peak_per_device`` (the analyzer's
    peak of live bytes on the rank, arguments included).  All per rank
    0; a decode record counts one decode step (the module's docstring).
    ``cache_policy`` places the decode state (``"heads"`` or ``"seq"``;
    the optimized preset's ``optimized_overrides`` choose it).

    Where the reference's numbers have no counterpart the port records
    its own: ``trace_s`` (the analysis) for ``lower_s`` and
    ``compile_s``; no ``xla_*_scanfolded``, because eager dispatch is
    unrolled and the flops count every layer; no ``output_bytes`` or
    ``temp_bytes``, whose sum with the arguments is the peak XLA plans
    for; and ``params``, the model's parameter count.  ``peak_top > 0``
    adds ``memory["at_peak"]``, the live bytes at the peak by the op,
    shape and dtype of the tensors that hold them
    (:func:`~repro_torch.launch.step_analysis.analyze_step`)."""
    from .step_analysis import analyze_step

    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if preset == "optimized":
        kw = optimized_overrides(cfg, shape)
        extra_opts = {**kw.get("extra_opts", {}), **(extra_opts or {})}
        rules_override = {**kw.get("rules_override", {}),
                          **(rules_override or {})} or None
        param_rules_override = {**kw.get("param_rules_override", {}),
                                **(param_rules_override or {})} or None
        cache_policy = kw.get("cache_policy", cache_policy)
        remat = kw.get("remat", remat)
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mode": shape.mode, "preset": preset}
    if not shape_supported(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch: long_500k requires "
                         "sub-quadratic attention (DESIGN.md)")
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    try:
        fn, args, plan = build_lowerable(
            cfg, shape, mesh, multi_pod, remat=remat,
            extra_opts=extra_opts, rules_override=rules_override,
            param_rules_override=param_rules_override,
            cache_policy=cache_policy)
        t1 = time.time()
        got = analyze_step(fn, args, world_size=plan.n_devices,
                           peak_top=peak_top)
        rec["status"] = "ok"
        rec["trace_s"] = round(time.time() - t1, 2)
        rec["params"] = param_count(model_spec(cfg))
        rec["flops"] = got["flops"]
        rec["bytes_written"] = got["bytes_written"]
        rec["collectives"] = got["collectives"]
        rec["memory"] = {"argument_bytes": _nbytes(args),
                         "peak_per_device": int(got["peak_bytes"])}
        if peak_top:
            rec["memory"]["at_peak"] = [
                {"bytes": n, "count": c, "op": op, "shape": list(shp),
                 "dtype": str(dt).replace("torch.", "")}
                for n, c, op, shp, dt in got["at_peak"]]
        if verbose:
            print(f"  cost: flops={rec['flops']:.3e} "
                  f"bytes={rec['bytes_written']:.3e} "
                  f"coll={rec['collectives']['total']:.3e}")
            print(f"  memory: {rec['memory']}")
    except Exception as e:
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--preset", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--peak-top", type=int, default=0,
                    help="record the N (op, shape, dtype) groups of most "
                         "bytes live at the peak "
                         "(traces each step twice)")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    counts = {}
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multipod" if mp else "pod"
                tag = f"{arch}_{shape}_{mesh_name}"
                print(f"[dryrun] {tag}", flush=True)
                rec = run_one(arch, shape, mp, preset=args.preset,
                              remat=False if args.no_remat else None,
                              peak_top=args.peak_top)
                print(f"  -> {rec['status']} ({rec.get('wall_s', 0)}s)"
                      + (f" {rec.get('error', '')}"
                         if rec["status"] == "fail" else ""), flush=True)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                counts[rec["status"]] = counts.get(rec["status"], 0) + 1
    print(f"[dryrun] done, {counts.get('fail', 0)} failures "
          f"({', '.join(f'{n} {k}' for k, n in sorted(counts.items()))})")
    raise SystemExit(1 if counts.get("fail") else 0)


if __name__ == "__main__":
    main()
