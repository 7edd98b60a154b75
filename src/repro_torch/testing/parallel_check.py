"""Parallelism-equivalence checker, the JAX package's
``repro.testing.parallel_check`` on process groups.

    PYTHONPATH=src python -m repro_torch.testing.parallel_check ARCH \\
        --ranks N [--device cpu|cuda]
    PYTHONPATH=src python -m repro_torch.testing.parallel_check ARCH \\
        --mesh 2x2|2x1x2 [--decode] [--device cpu|cuda]

spawns N ranks (gloo on the CPU, NCCL on CUDA, where rank r takes card
r; NCCL refuses two ranks on one card) and, for every technique in the
search space of ``ARCH``'s reduced config at N devices, runs one train step on the N ranks and holds it against the
port's one-device step from the same parameters and batch: the loss
and every parameter within ``--tol`` (2e-2), the reference's contract.
Prints one line per technique, with a rank's resident bytes and its
peak bytes in the step and in the checkpoint's gather
(:func:`peak_bytes`) over P, the one-device parameter bytes, and exits
non-zero on any ``FAIL``.  With ``--mesh`` it runs the dry run's 2-D
(or 3-D) rules plan on 4 ranks instead (:func:`check_rules`): one train
step without and with remat, and a prefill whose every rank's last
logits and state parts are held against the one-device prefill.  With
``--mesh`` and ``--decode`` (:func:`check_decode`) it runs greedy decode
steps under that plan from a random state placed by
``launch.mesh.cache_shardings`` under each cache policy, against the
one-device ``decode_step``.

:func:`technique_steps` is the per-rank work of the check, and
:func:`segments` trains checkpointed segments under changing
techniques; the port's tests run both through
:func:`~repro_torch.parallelism.dist.spawn`.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

DEFAULT_TOL = 2e-2


def peak_bytes(fn, device):
    """(fn(), the most bytes that fn held allocated on ``device`` at once
    beyond what was allocated before it): CUDA's allocator statistics on
    a card, the profiler's allocation events on the CPU.

    The profiler sees the frees of its own thread only, and gloo's
    worker threads sometimes drop the last reference to a tensor that a
    collective was given.  A block whose free went unseen is counted as
    freed when the allocator hands its address out again; one whose
    address is never reused stays counted, so the CPU figure may
    overstate the peak, never understate it."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fn()
        torch.cuda.synchronize(device)
        return out, torch.cuda.max_memory_allocated(device) - before
    from torch._C._profiler import _EventType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = fn()

    def walk(nodes):
        for e in nodes:
            yield e
            yield from walk(e.children)

    events = sorted((e for e in walk(
        prof.profiler.kineto_results.experimental_event_tree())
        if e.typed[0] == _EventType.Allocation),
        key=lambda e: e.start_time_ns)
    live = {}
    held = peak = 0
    for e in events:
        ptr, size = e.typed[1].ptr, e.typed[1].alloc_size
        held -= live.pop(ptr, 0)
        if size > 0:
            live[ptr] = size
            held += size
            peak = max(peak, held)
    return out, peak


def technique_steps(group, cfg, opt_cfg, params_np, batch_np, techniques,
                    measure=False):
    """Per rank: for each technique name, one train step of ``cfg`` at
    ``group.size`` devices from the full parameters ``params_np``
    (slash-joined path -> array) on the global batch ``batch_np``.
    Returns, on rank 0, per technique: the full parameters, mu and nu
    after the step (numpy), its metrics, and every rank's resident
    parameter + mu + nu bytes; with ``measure``, also every rank's
    :func:`peak_bytes` in the step and in the checkpoint's gather."""
    import torch

    from ..models.params import params_from_numpy, params_to_numpy
    from ..optim.adamw import init_opt_state
    from ..parallelism import collectives as C
    from ..parallelism.build import BuiltJob, _leaves
    from ..parallelism.techniques import DEFAULT_TECHNIQUES
    by_name = {t.name: t for t in DEFAULT_TECHNIQUES}
    batch = {k: torch.as_tensor(v, device=group.device)
             for k, v in batch_np.items()}
    results = {}
    for name in techniques:
        plan = by_name[name].plan(cfg, group.size)
        job = BuiltJob(cfg, plan, opt_cfg, group=group)
        params = job.shard(params_from_numpy(params_np, device=group.device))
        opt = init_opt_state(params)
        resident = sum(t.numel() * t.element_size() for t in
                       _leaves(params) + _leaves(opt["mu"])
                       + _leaves(opt["nu"]))
        local = job.place_batch(batch)
        if measure:
            (params, opt, m), step_peak = peak_bytes(
                lambda: job.step(params, opt, local), group.device)
            full, commit_peak = peak_bytes(
                lambda: job.full_state(params, opt), group.device)
        else:
            params, opt, m = job.step(params, opt, local)
            full = job.full_state(params, opt)
            step_peak = commit_peak = 0
        per_rank = C.all_gather(torch.tensor(
            [[float(resident), float(step_peak), float(commit_peak)]],
            device=group.device), 0, job.world).cpu()
        if group.rank == 0:
            results[name] = {
                "params": params_to_numpy(full["params"]),
                "mu": params_to_numpy(full["opt"]["mu"]),
                "nu": params_to_numpy(full["opt"]["nu"]),
                "step": int(full["opt"]["step"]),
                "metrics": {k: float(v) for k, v in m.items()},
                "resident_bytes": per_rank[:, 0].tolist(),
                "step_peak_bytes": per_rank[:, 1].tolist(),
                "commit_peak_bytes": per_rank[:, 2].tolist()}
    return results


def technique_runs(group, cfg, opt_cfg, inits, batch_np, techniques,
                   measure=()):
    """:func:`technique_steps` from each of several initial parameter
    trees (name -> path -> array) in one group, measuring the peaks of
    the inits named in ``measure``; results by name."""
    return {name: technique_steps(group, cfg, opt_cfg, params_np, batch_np,
                                  techniques, measure=name in measure)
            for name, params_np in inits.items()}


def segments(group, cfg, opt_cfg, segs):
    """Per rank: for each (technique, ckpt_in, ckpt_out, batch_np) in
    ``segs``, build the technique at ``group.size`` devices, resume from
    ``ckpt_in``, take one step and write ``ckpt_out`` (rank 0, the full
    tree).  Returns each step's metrics on rank 0."""
    import torch
    import torch.distributed as dist

    from ..checkpoint.store import save_checkpoint
    from ..parallelism.build import BuiltJob
    from ..parallelism.techniques import DEFAULT_TECHNIQUES
    by_name = {t.name: t for t in DEFAULT_TECHNIQUES}
    out = []
    for name, ckpt_in, ckpt_out, batch_np in segs:
        job = BuiltJob(cfg, by_name[name].plan(cfg, group.size), opt_cfg,
                       group=group)
        params, opt = job.init(0)
        params, opt, start = job.load(ckpt_in, params, opt)
        batch = {k: torch.as_tensor(v, device=group.device)
                 for k, v in batch_np.items()}
        params, opt, m = job.step(params, opt, job.place_batch(batch))
        tree = job.full_state(params, opt)
        m = {k: float(v) for k, v in m.items()}
        if tree is not None:
            save_checkpoint(ckpt_out, tree,
                            {"step": start + 1, "loss": m["loss"]})
        dist.barrier()      # the next segment's ranks read ckpt_out
        out.append(m)
    return out


# the meshes of ``--mesh``: 2-D FSDP x TP, and a tuple batch axis over
# two pods with TP inside each
MESHES = {"2x2": (("data", 2), ("model", 2)),
          "2x1x2": (("pod", 2), ("data", 1), ("model", 2))}
# steps timed after the held one in check_rules
WARM_STEPS = 3


def rules_plan(cfg, mesh_axes, remat: bool = False,
               rules_override: Optional[dict] = None):
    """The dry run's layout on a small mesh: the production parameter
    rules at ``mesh_axes``' sizes (``launch.mesh``; "embed" over data,
    the heads, ffn, experts, vocab and rnn that divide over model) and
    the batch over ("pod",) "data", then ``rules_override``."""
    import math

    from ..launch.mesh import batch_axes, production_param_rules
    from ..parallelism.base import Plan
    multi_pod = "pod" in dict(mesh_axes)
    prules = production_param_rules(cfg, mesh_axes, multi_pod)
    rules = {**prules, "batch": batch_axes(multi_pod), "seq": None,
             **(rules_override or {})}
    return Plan("rules", math.prod(n for _, n in mesh_axes),
                tuple(mesh_axes), rules, param_policy="rules", remat=remat)


def rules_runs(group, cfg, opt_cfg, params_np, batch_np, mesh_axes,
               warm_steps: int = 0):
    """Per rank, under :func:`rules_plan`: one train step from the full
    parameters ``params_np`` on the global batch ``batch_np`` without
    and with remat, and a prefill of that batch.  Returns, on rank 0,
    each step's full parameters, mu, nu, metrics (numpy; keyed by
    remat) and seconds, and every rank's prefill parts: its mesh
    coordinates, its last logits and its part of each state leaf
    (slash-joined path); ``prefill_s`` is rank 0's prefill seconds.
    The held step is a first one, warm-up included; ``warm_steps`` more
    steps after it are timed alone (``warm_step_s``)."""
    import time

    import torch
    import torch.distributed as dist

    from ..models.params import (params_from_numpy, params_to_numpy,
                                 tree_leaves_with_paths)
    from ..models.transformer import prefill_forward
    from ..optim.adamw import init_opt_state
    from ..parallelism.build import BuiltJob
    batch = {k: torch.as_tensor(v, device=group.device)
             for k, v in batch_np.items()}

    def timed(fn):
        """fn() and its seconds on this rank, the device synchronised."""
        dist.barrier()
        t0 = time.perf_counter()
        got = fn()
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        return got, time.perf_counter() - t0

    out = {}
    for remat in (False, True):
        job = BuiltJob(cfg, rules_plan(cfg, mesh_axes, remat), opt_cfg,
                       group=group)
        params = job.shard(params_from_numpy(params_np, device=group.device))
        opt = init_opt_state(params)
        local = job.place_batch(batch)
        (params, opt, m), secs = timed(lambda: job.step(params, opt, local))
        full = job.full_state(params, opt)
        if group.rank == 0:
            # copies: on the CPU a whole leaf is the rank's own tensor,
            # which the timed steps update in place
            copy = lambda t: {k: v.copy()
                              for k, v in params_to_numpy(t).items()}
            out[remat] = {
                "params": copy(full["params"]),
                "mu": copy(full["opt"]["mu"]),
                "nu": copy(full["opt"]["nu"]),
                "step": int(full["opt"]["step"]),
                "metrics": {k: float(v) for k, v in m.items()},
                "step_s": secs}
        warm = [timed(lambda: job.step(params, opt, local))[1]
                for _ in range(warm_steps)]
        if group.rank == 0:
            out[remat]["warm_step_s"] = warm
    job = BuiltJob(cfg, rules_plan(cfg, mesh_axes), opt_cfg, group=group)
    params = job.shard(params_from_numpy(params_np, device=group.device))
    local = job.place_batch(batch)

    def prefill():
        with torch.no_grad(), job.running(params):
            return prefill_forward(params, cfg, local, opts={})
    (logits, state), prefill_s = timed(prefill)
    out["prefill_s"] = prefill_s
    mine = {"coords": dict(zip(job.mesh.names, job.mesh.coords)),
            "logits": logits.cpu().numpy(),
            "pos": int(state["pos"]),
            "state": {"/".join(p): t.cpu().numpy() for p, t in
                      tree_leaves_with_paths(state["layers"])}}
    parts = [None] * group.size if group.rank == 0 else None
    dist.gather_object(mine, parts, dst=0)
    if group.rank == 0:
        out["prefill"] = parts
    return out


def rules_runs_on(group, cfg, opt_cfg, params_np, batch_np, meshes):
    """:func:`rules_runs` on each mesh of ``meshes`` (name -> mesh axes)
    in one group; results by name."""
    return {name: rules_runs(group, cfg, opt_cfg, params_np, batch_np, axes)
            for name, axes in meshes.items()}


def expected_part(full, part_shape, coords, mesh_axes, batch_dim,
                  placement=None):
    """The slice of a one-device output ``full`` that a rank at
    ``coords`` holds.  Without ``placement``: its rows along
    ``batch_dim`` (the ("pod", "data") index, row-major) and, on a dim
    the rank holds a ``model``-th of, its model index's part.  With
    ``placement`` (a mesh axis, a tuple of axes or None a dim): on each
    cut dim, its part at its row-major index over the dim's axes."""
    import numpy as np

    from ..parallelism.shardings import axis_names
    sizes = dict(mesh_axes)
    index = lambda axes: int(np.ravel_multi_index(
        [coords[a] for a in axes], [sizes[a] for a in axes]))
    at = []
    for d, (n, k) in enumerate(zip(full.shape, part_shape)):
        if n == k:
            at.append(slice(None))
            continue
        if placement is not None:
            idx = index(axis_names(placement[d]))
        elif d == batch_dim:
            idx = index([a for a in ("pod", "data") if a in sizes])
        else:
            idx = coords["model"]
        at.append(slice(idx * k, (idx + 1) * k))
    return full[tuple(at)]


# greedy decode steps of a decode check, each feeding back its argmax
DECODE_STEPS = 3
# check_decode's decode state: its length, first position and seed
DECODE_LEN, DECODE_POS, DECODE_SEED = 64, 41, 7


def random_decode_state(cfg, batch: int, length: int, seed: int = 0):
    """{path: array} of a decode state's layers (the layout of
    ``init_decode_state``) in fp32, drawn from ``seed``: the KV caches
    and the recurrent states standard normal, every stabilizer ``m``
    finite (uniform in [-2, 2]) and the sLSTM's normalizer ``n``
    positive."""
    import numpy as np

    from ..models.params import tree_leaves_with_paths
    from ..models.transformer import decode_state_spec
    rng = np.random.RandomState(seed)
    out = {}
    for path, s in tree_leaves_with_paths(
            decode_state_spec(cfg, batch, length)["layers"]):
        shape = tuple(s.shape)
        if path[-1] == "m":
            a = rng.uniform(-2.0, 2.0, shape)
        elif path[-1] == "n" and "slstm" in path[-2]:
            a = 1.0 + np.abs(rng.standard_normal(shape))
        else:
            a = rng.standard_normal(shape)
        out["/".join(("layers",) + path)] = a.astype(np.float32)
    return out


def decode_case(policy: str, tokens, state_np, pos: int, length: int,
                rules_override: Optional[dict] = None):
    """One case of :func:`decode_runs`: the state's ``policy``
    (``launch.mesh.cache_shardings``), the first tokens (B, 1), the
    whole state of KV caches of ``length`` (:func:`random_decode_state`)
    at ``pos``, and the rules over :func:`rules_plan`'s (``{"batch":
    None}``: every rank runs every row)."""
    return {"policy": policy, "tokens": tokens, "state": state_np,
            "pos": pos, "length": length, "rules": rules_override}


def _decode_state(state_np, pos: int, device):
    """The decode state tree of :func:`random_decode_state`'s arrays."""
    import torch

    from ..models.params import params_from_numpy
    tree = params_from_numpy(state_np, device=device)
    tree["pos"] = torch.tensor(pos, dtype=torch.int32, device=device)
    return tree


def greedy_decode(cfg, params, tokens, state, steps: int, job=None,
                  layout=None):
    """``steps`` greedy decode steps of ``decode_step`` from ``tokens``
    (B, 1) and ``state`` (updated in place), each feeding back
    ``greedy_tokens``; inside ``job.running(params, layout)`` where a
    job is given.  Returns ([(logits, tokens)] a step, the last
    state)."""
    import contextlib

    import torch

    from ..models.transformer import decode_step, greedy_tokens
    ctx = contextlib.nullcontext() if job is None \
        else job.running(params, layout)
    out = []
    with torch.no_grad(), ctx:
        for _ in range(steps):
            logits, state = decode_step(params, cfg, tokens, state, opts={})
            tokens = greedy_tokens(logits)
            out.append((logits, tokens))
    return out, state


def decode_runs(group, cfg, params_np, cases, mesh_axes):
    """Per rank, for each case of ``cases`` (name -> :func:`decode_case`):
    under :func:`rules_plan` on ``mesh_axes``, the rank's part of the
    whole state under the case's placements
    (``BuiltJob.shard_state``), its rows of the tokens, and
    :data:`DECODE_STEPS` greedy steps of ``decode_step`` inside
    ``running(params, layout)``, each feeding back ``greedy_tokens``.
    Returns, on rank 0, each case's parts of every rank: its mesh
    coordinates, the placements of the logits' rows and vocab and of
    each state leaf, each step's logits and tokens, and its part of each
    state leaf after the last step (slash-joined path) with the final
    ``pos``."""
    import torch
    import torch.distributed as dist

    from ..launch.mesh import cache_shardings
    from ..models.config import InputShape
    from ..models.params import params_from_numpy, tree_leaves_with_paths
    from ..optim.adamw import AdamWConfig
    from ..parallelism.build import BuiltJob
    from ..parallelism.shardings import placement_leaves
    multi_pod = "pod" in dict(mesh_axes)
    out = {}
    for name, case in cases.items():
        b = case["tokens"].shape[0]
        layout, _ = cache_shardings(
            cfg, InputShape("decode", case["length"], b, "decode"),
            mesh_axes, multi_pod, policy=case["policy"])
        job = BuiltJob(cfg, rules_plan(cfg, mesh_axes,
                                       rules_override=case["rules"]),
                       AdamWConfig(), group=group)
        params = job.shard(params_from_numpy(params_np, device=group.device))
        state = job.shard_state(_decode_state(case["state"], case["pos"],
                                              group.device), layout)
        tok = job.place_batch({"tokens": torch.as_tensor(
            case["tokens"])})["tokens"]
        steps, state = greedy_decode(cfg, params, tok, state, DECODE_STEPS,
                                     job, layout)
        mine = {"coords": dict(zip(job.mesh.names, job.mesh.coords)),
                "logits_placement": (job.rules.get("batch"), None,
                                     job.rules.get("vocab")),
                "layout": {"/".join(p): pl for p, pl in
                           placement_leaves(layout["layers"])},
                "steps": [{"logits": lg.cpu().numpy(),
                           "tokens": t.cpu().numpy()} for lg, t in steps],
                "pos": int(state["pos"]),
                "state": {"/".join(p): t.cpu().numpy() for p, t in
                          tree_leaves_with_paths(state["layers"])}}
        parts = [None] * group.size if group.rank == 0 else None
        dist.gather_object(mine, parts, dst=0)
        if group.rank == 0:
            out[name] = parts
    return out


def decode_runs_on(group, cfg, params_np, cases, meshes):
    """:func:`decode_runs` on each mesh of ``meshes`` (name -> mesh axes)
    in one group; results by mesh name."""
    return {name: decode_runs(group, cfg, params_np, cases, axes)
            for name, axes in meshes.items()}


def check_rules(arch_id: str = "h2o-danube-3-4b", mesh: str = "2x2",
                device: str = "cpu", tol: float = DEFAULT_TOL):
    """A rules plan on ``mesh`` (:data:`MESHES`) against the port's one
    device: one train step without and with remat (loss, every
    parameter and the gradient norm, relative, within ``tol``) and a
    prefill (every rank's last logits
    and its part of each state leaf within ``tol`` of the leaf's largest
    value); one result a check."""
    import numpy as np

    from ..configs import concrete_batch, get_config
    from ..models.params import (params_from_numpy, params_to_numpy,
                                 tree_leaves_with_paths)
    from ..models.transformer import prefill_forward, state_batch_axes
    from ..optim.adamw import AdamWConfig
    from ..parallelism.build import BuiltJob
    from ..parallelism.dist import spawn
    from ..parallelism.techniques import DDP

    mesh_axes = MESHES[mesh]
    cfg = get_config(arch_id).reduced(num_layers=4)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    base = BuiltJob(cfg, DDP().plan(cfg, 1), opt_cfg, device="cpu")
    params, opt = base.init(42)
    params_np = {k: v.copy() for k, v in params_to_numpy(params).items()}
    batch = concrete_batch(cfg, 8, 32, device="cpu")
    ref_logits, ref_state = prefill_forward(
        params_from_numpy(params_np, device="cpu"), cfg, batch, opts={})
    p_ref, _, m_ref = base.step(params, opt, batch)
    ref = params_to_numpy(p_ref)
    ref_loss = float(m_ref["loss"])
    print(f"[baseline] {arch_id} loss={ref_loss:.6f}", flush=True)
    plan = rules_plan(cfg, mesh_axes)
    devices = [f"cuda:{r}" if device == "cuda" else "cpu"
               for r in range(plan.n_devices)]
    got = spawn(rules_runs, devices, cfg, opt_cfg, params_np,
                {k: v.numpy() for k, v in batch.items()}, mesh_axes,
                WARM_STEPS)
    results = []
    for remat in (False, True):
        r = got[remat]
        loss = r["metrics"]["loss"]
        diff = max(float(np.max(np.abs(r["params"][k] - ref[k])))
                   for k in ref)
        # the first AdamW step moves a parameter by about lr whatever
        # its gradient's size, so the gradient is held by its norm
        ref_gn = float(m_ref["grad_norm"])
        dgn = abs(r["metrics"]["grad_norm"] - ref_gn) / ref_gn
        ok = abs(loss - ref_loss) < tol and diff < tol and dgn < tol
        name = f"rules {mesh}{' remat' if remat else ''}"
        print(f"[{name}] loss={loss:.6f} dloss={abs(loss - ref_loss):.2e} "
              f"max_param_diff={diff:.2e} rel_dgrad_norm={dgn:.2e} "
              f"first_step_s={r['step_s']:.3f} "
              f"warm_step_s={','.join(f'{t:.4f}' for t in r['warm_step_s'])}"
              f" {'OK' if ok else 'FAIL'}", flush=True)
        results.append({"check": name, "loss": loss, "ok": ok,
                         "dloss": abs(loss - ref_loss),
                         "max_param_diff": diff, "rel_dgrad_norm": dgn,
                         "step_s": r["step_s"],
                         "warm_step_s": r["warm_step_s"]})
    full = {"/".join(p): t.numpy() for p, t in
            tree_leaves_with_paths(ref_state["layers"])}
    axes = {"/".join(p): a for p, a in
            tree_leaves_with_paths(state_batch_axes(cfg)["layers"])}
    # relative to each output's largest value: on the raw init the
    # residual stream reaches |x| ~ 100 and the caches and logits with it
    diff = 0.0

    def worst(part, want):
        err = float(np.max(np.abs(part - want)))
        return err / max(float(np.max(np.abs(want))), 1e-30)
    for part in got["prefill"]:
        diff = max(diff, worst(part["logits"], expected_part(
            ref_logits.numpy(), part["logits"].shape, part["coords"],
            mesh_axes, 0)))
        for k, v in part["state"].items():
            diff = max(diff, worst(v, expected_part(
                full[k], v.shape, part["coords"], mesh_axes, axes[k])))
    ok = diff < tol
    print(f"[prefill {mesh}] rules={plan.rules} max_rel_diff="
          f"{diff:.2e} prefill_s={got['prefill_s']:.3f} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    results.append({"check": f"prefill {mesh}", "ok": ok,
                    "max_rel_diff": diff, "prefill_s": got["prefill_s"]})
    return results


def decode_cases(cfg, batch: int = 8):
    """:func:`check_decode`'s cases: both cache policies at ``batch`` and,
    for a long-context arch, at B 1 with the batch left whole; an MoE
    arch also takes the optimized preset's decode overrides."""
    import numpy as np

    from ..launch.dryrun import optimized_overrides
    from ..models.config import INPUT_SHAPES
    cases = {}
    for b in (batch, 1) if cfg.long_context else (batch,):
        state = random_decode_state(cfg, b, DECODE_LEN, DECODE_SEED + b)
        tokens = np.random.RandomState(DECODE_SEED + 100 + b).randint(
            0, cfg.vocab_size, (b, 1)).astype(np.int32)
        rules = None if b == batch else {"batch": None}
        for policy in ("heads", "seq"):
            cases[f"{policy}-b{b}"] = decode_case(
                policy, tokens, state, DECODE_POS, DECODE_LEN, rules)
        if cfg.is_moe and b == batch:
            kw = optimized_overrides(cfg, INPUT_SHAPES["decode_32k"])
            cases[f"optimized-b{b}"] = decode_case(
                kw.get("cache_policy", "heads"), tokens, state, DECODE_POS,
                DECODE_LEN, kw.get("rules_override"))
    return cases


def check_decode(arch_id: str = "h2o-danube-3-4b", mesh: str = "2x2",
                 device: str = "cpu", tol: float = DEFAULT_TOL):
    """Decode under a rules plan on ``mesh`` (:data:`MESHES`) against the
    port's one device, for each of :func:`decode_cases`:
    :data:`DECODE_STEPS` greedy steps from a random state, each step's
    tokens equal and every rank's part of its logits and, after the
    last step, of each state leaf within ``tol`` of the output's
    largest value; one result a case."""
    import time

    import numpy as np
    import torch

    from ..configs import get_config
    from ..models.params import params_from_numpy, tree_leaves_with_paths
    from ..optim.adamw import AdamWConfig
    from ..parallelism.build import BuiltJob
    from ..parallelism.dist import spawn
    from ..parallelism.techniques import DDP

    mesh_axes = MESHES[mesh]
    cfg = get_config(arch_id).reduced(num_layers=4)
    base = BuiltJob(cfg, DDP().plan(cfg, 1), AdamWConfig(), device="cpu")
    params, _ = base.init(42)
    params_np = {"/".join(p): t.numpy().copy()
                 for p, t in tree_leaves_with_paths(params)}
    cases = decode_cases(cfg)
    devices = [f"cuda:{r}" if device == "cuda" else "cpu"
               for r in range(4)]
    t0 = time.perf_counter()
    got = spawn(decode_runs, devices, cfg, params_np, cases, mesh_axes)
    spawn_s = time.perf_counter() - t0
    worst = lambda part, want: float(np.max(np.abs(part - want))) / max(
        float(np.max(np.abs(want))), 1e-30)
    results = []
    for name, case in cases.items():
        steps, state = greedy_decode(
            cfg, params_from_numpy(params_np, device="cpu"),
            torch.as_tensor(case["tokens"]),
            _decode_state(case["state"], case["pos"], "cpu"), DECODE_STEPS)
        full = {"/".join(p): t.numpy() for p, t in
                tree_leaves_with_paths(state["layers"])}
        same, diff = True, 0.0
        for part in got[name]:
            pl = part["logits_placement"]
            for (logits, tokens), mine in zip(steps, part["steps"]):
                same &= bool(np.array_equal(mine["tokens"], expected_part(
                    tokens.numpy(), mine["tokens"].shape, part["coords"],
                    mesh_axes, 0, pl[:2])))
                diff = max(diff, worst(mine["logits"], expected_part(
                    logits.numpy(), mine["logits"].shape, part["coords"],
                    mesh_axes, 0, pl)))
            for k, v in part["state"].items():
                diff = max(diff, worst(v, expected_part(
                    full[k], v.shape, part["coords"], mesh_axes, None,
                    part["layout"][k])))
        ok = same and diff < tol
        print(f"[decode {mesh} {name}] policy={case['policy']} "
              f"rules={case['rules']} tokens_equal={same} "
              f"max_rel_diff={diff:.2e} {'OK' if ok else 'FAIL'}",
              flush=True)
        results.append({"check": f"decode {mesh} {name}", "ok": ok,
                        "tokens_equal": same, "max_rel_diff": diff})
    print(f"[decode {mesh}] {len(cases)} cases on {len(devices)} ranks in "
          f"{spawn_s:.1f} s (spawn included)", flush=True)
    return results


def check(arch_id: str = "h2o-danube-3-4b", ranks: int = 2,
          device: str = "cpu", tol: float = DEFAULT_TOL):
    """The reference's contract on ``ranks`` ranks; returns one result a
    technique in the search space (its loss, the loss's and the largest
    parameter's distance from the baseline, and whether both are within
    ``tol``)."""
    import numpy as np

    from ..configs import concrete_batch, get_config
    from ..models.params import params_to_numpy
    from ..optim.adamw import AdamWConfig
    from ..parallelism.build import BuiltJob
    from ..parallelism.dist import spawn
    from ..parallelism.techniques import DEFAULT_TECHNIQUES, DDP

    cfg = get_config(arch_id).reduced(num_layers=4)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    # the baseline on the CPU, the ranks on ``device``
    base = BuiltJob(cfg, DDP().plan(cfg, 1), opt_cfg, device="cpu")
    params, opt = base.init(42)
    # copies: the step below updates ``params`` in place
    params_np = {k: v.copy() for k, v in params_to_numpy(params).items()}
    batch = concrete_batch(cfg, 8, 32, device="cpu")
    p_ref, _, m_ref = base.step(params, opt, batch)
    ref = params_to_numpy(p_ref)
    ref_loss = float(m_ref["loss"])
    print(f"[baseline] {arch_id} loss={ref_loss:.6f}", flush=True)

    names = [t.name for t in DEFAULT_TECHNIQUES
             if t.search_space(cfg, ranks)]
    for t in DEFAULT_TECHNIQUES:
        if t.name not in names:
            print(f"[{t.name}] not in search space for {arch_id}@{ranks} "
                  "— skipped", flush=True)
    devices = [f"cuda:{r}" if device == "cuda" else "cpu"
               for r in range(ranks)]
    got = spawn(technique_steps, devices, cfg, opt_cfg, params_np,
                {k: v.numpy() for k, v in batch.items()}, names, True)
    p_bytes = 4.0 * sum(v.size for v in ref.values())
    results = []
    for name in names:
        r = got[name]
        loss = r["metrics"]["loss"]
        diff = max(float(np.max(np.abs(r["params"][k] - ref[k])))
                   for k in ref)
        ok = abs(loss - ref_loss) < tol and diff < tol
        # a rank's bytes over P, the one-device parameter bytes: the
        # largest over the ranks, rank 0's commit apart
        peaks = {"resident_P": max(r["resident_bytes"]) / p_bytes,
                 "step_peak_P": max(r["step_peak_bytes"]) / p_bytes,
                 "commit_peak_P_rank0": r["commit_peak_bytes"][0] / p_bytes,
                 "commit_peak_P_others":
                     max(r["commit_peak_bytes"][1:], default=0.0) / p_bytes}
        print(f"[{name}] loss={loss:.6f} dloss={abs(loss - ref_loss):.2e} "
              f"max_param_diff={diff:.2e} "
              + " ".join(f"{k}={v:.3f}" for k, v in peaks.items())
              + f" {'OK' if ok else 'FAIL'}", flush=True)
        results.append({"technique": name, "loss": loss,
                        "dloss": abs(loss - ref_loss),
                        "max_param_diff": diff, "ok": ok, **peaks})
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="h2o-danube-3-4b")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mesh", choices=sorted(MESHES),
                    help="a rules plan on this mesh (4 ranks) in place of "
                         "the techniques at --ranks")
    ap.add_argument("--decode", action="store_true",
                    help="with --mesh: greedy decode steps under the rules "
                         "plan in place of the train step and prefill")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL)
    args = ap.parse_args(argv)
    ranks = 4 if args.mesh else args.ranks
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < ranks:
            print(f"parallel_check: {ranks} ranks need as many cards "
                  f"(found {torch.cuda.device_count()})", file=sys.stderr)
            return 2
    if args.decode and not args.mesh:
        ap.error("--decode needs --mesh")
    if args.decode:
        results = check_decode(args.arch, args.mesh, args.device, args.tol)
    elif args.mesh:
        results = check_rules(args.arch, args.mesh, args.device, args.tol)
    else:
        results = check(args.arch, args.ranks, args.device, args.tol)
    return int(not all(r["ok"] for r in results))


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
