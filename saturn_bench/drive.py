"""One run of a cell: a Saturn job's training segment on the program,
timed, then checked against the reference.

The job is built as the executor builds it (``LocalTorchBackend.
_built_job``): ``BuiltJob(cfg, technique.plan(cfg, chips), job.opt_cfg)``,
and driven by the executor's loop (``_Worker._train``):
``built.step(params, opt, built.place_batch(batch))``, then
``float(metrics["loss"])`` each step.  The loop's checkpoint and its
data stream are left out.  The inputs are the benchmark's, drawn on the
device from the seed in set-up and handed alike to the program and to
the reference: the weights (``reference.params``: the source's
``initializer_range``, in the program's layout, taken by the job
through ``BuiltJob.shard`` with a zero AdamW state from
``init_opt_state``) and a ring of token batches.

Set-up runs the checked steps, the first of the ring, through the same
call and feed, reads what ``correct`` compares from them, and hands the
same job state to the window.  The window runs whole steps until the
seconds have passed; its rate is all its tokens over the time from the
first step's start to the last step's end.  After it (and, in a traced
run, a profiled window of a few more steps) the program's state is
freed and the reference trains from the seed's weights on the same
checked batches.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import time
from typing import Optional

import torch

from . import cells, check, faults, flops, trace as tracing
from .reference import params as ref_params, train as ref_train

GIB = 2 ** 30


def process_age() -> float:
    """Seconds since this process started (its start as the kernel
    recorded it, so the interpreter's own start-up counts)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader may read."""
    config: dict
    traffic: dict
    chips: int
    steps: int                    # steps in the measured window
    tokens: int                   # tokens trained in it
    window_s: float
    model_flops: int              # model FLOPs of the window's steps
    peak_flops: Optional[float]   # the card's fp32 peak (None: not known)
    trace: Optional[tracing.Trace] = None


def token_ring(seed: int, traffic: dict, vocab: int, device) -> torch.Tensor:
    """(ring, batch, seq) int32 tokens, uniform over the vocabulary,
    from a generator on the device seeded apart from the weights'."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + 1) * 0x9E3779B1 % (1 << 63))
    shape = (traffic["ring"], traffic["batch"], traffic["seq_len"])
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _by_path(tree) -> dict:
    from repro_torch.models.params import tree_leaves_with_paths
    return {"/".join(p): t for p, t in tree_leaves_with_paths(tree)}


def _job(cell: cells.Cell, seed: int, device):
    from repro_torch.core.job import Job
    from repro_torch.core.library import ParallelismLibrary
    from repro_torch.parallelism.build import BuiltJob
    tr = cell.traffic
    cfg = cells.model_config(cell.config)
    job = Job(cell.name, cfg, tr["batch"], tr["seq_len"], tr["total_steps"],
              lr=tr["lr"], seed=seed)
    opt = dataclasses.asdict(job.opt_cfg)
    stated = dict(tr["optimizer"], lr=tr["lr"], total_steps=tr["total_steps"])
    if opt != stated:
        raise ValueError(f"the job's optimizer {opt} is not the one the "
                         f"workload states, {stated}")
    plan = ParallelismLibrary().get(tr["technique"]).plan(cfg, cell.chips)
    return BuiltJob(cfg, plan, job.opt_cfg, device=device), opt


def start(cell: cells.Cell, seed: int, device, fault: Optional[str] = None):
    """Set-up up to the window: the job built and initialised, the ring
    drawn, the checked steps run.  Returns (built, params, state, feed,
    ring, opt, prog), prog holding what ``check.numbers`` reads of the
    program."""
    if cell.chips != 1:
        raise NotImplementedError("cells of more than one card")
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 products must run in float32 (TF32 on)")
    from repro_torch.optim.adamw import init_opt_state
    built, opt = _job(cell, seed, device)
    params = built.shard(ref_params.nest(ref_params.init(cell.config, seed,
                                                         device)))
    state = init_opt_state(params)
    ring = token_ring(seed, cell.traffic, cell.config["vocab_size"], device)
    feed = faults.feed(fault, lambda i: {"tokens": ring[i % len(ring)]},
                       cell.config["vocab_size"])
    prog = {"losses": []}
    for i in range(cell.traffic["checked_steps"]):
        params, state, m = built.step(params, state,
                                      built.place_batch(feed(i)))
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad_norms"] = {
                k: v / (1 - opt["b1"]) for k, v in
                ref_train.leaf_norms(_by_path(state["mu"])).items()}
    prog["change_norms"] = ref_train.change_norms(
        cell.config, seed, _by_path(params))
    return built, params, state, feed, ring, opt, prog


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference(cell: cells.Cell, opt: dict, ring, seed: int, device,
              tf32: bool = False) -> dict:
    return ref_train.run(cell.config, opt,
                         [ring[i] for i in range(cell.traffic["checked_steps"])],
                         seed, device, tf32=tf32)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool = False,
             device="cuda", fault: Optional[str] = None) -> dict:
    """One run: the result line's dict (without ``device``'s name and
    count, which the caller adds)."""
    dev = torch.device(device)
    tr = cell.traffic
    n_checked = tr["checked_steps"]
    with faults.planted(fault):
        built, params, state, feed, ring, opt, prog = start(cell, seed, dev,
                                                            fault)
        _sync(dev)
        setup_s = process_age()

        steps = failed = 0
        t0 = time.perf_counter()
        while True:
            params, state, m = built.step(
                params, state, built.place_batch(feed(n_checked + steps)))
            failed += not math.isfinite(float(m["loss"]))
            steps += 1
            window_s = time.perf_counter() - t0
            if window_s >= seconds:
                break
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else None

        profiled = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                with record_function(tracing.WINDOW_SPAN):
                    for i in range(tr["profile_steps"]):
                        params, state, m = built.step(
                            params, state, built.place_batch(
                                feed(n_checked + steps + i)))
                        float(m["loss"])
                    _sync(dev)
            profiled = tracing.from_profiler(prof)
            del prof

    del params, state, m, built
    free(dev)
    values = check.numbers(prog, reference(cell, opt, ring, seed, dev))
    limits = tr["limits"]
    tokens = steps * tr["batch"] * tr["seq_len"] * cell.chips
    run = Run(cell.config, tr, cell.chips, steps, tokens, window_s,
              steps * flops.step_flops(cell.config, tr["batch"],
                                       tr["seq_len"]) * cell.chips,
              flops.PEAK_FP32_FLOPS.get(
                  torch.cuda.get_device_name(dev)
                  if dev.type == "cuda" else ""), profiled)
    e2e = {"train_tokens_per_s": tokens / window_s,
           "peak_mem_gib": None if peak is None else peak / GIB,
           "setup_s": setup_s}
    if trace:
        reads = {m["name"]: (m["unit"], cells.reader(m["name"])(run))
                 for m in cell.per_layer}
    else:
        reads = {m["name"]: (m["unit"], e2e[m["name"]])
                 for m in cell.end_to_end}
    result = {
        "correct": check.judge(values, limits) and failed == 0,
        "attempted": steps, "failed": failed,
        "metrics": {n: {"value": v, "unit": u} for n, (u, v) in reads.items()
                    if v is not None},
        "device": {"memory_peak_bytes": peak},
    }
    if profiled is not None:
        busy = tracing.length(profiled.busy())
        result["device"].update(busy_s=busy, window_s=profiled.window_s)
        result["breakdown"] = tracing.breakdown(profiled)
    result["checks"] = {n: {"value": values[n], "limit": lim}
                        for n, lim in limits.items()}
    return result
