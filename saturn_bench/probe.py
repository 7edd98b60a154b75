"""The probe that chose a cell's technique and batch, as Saturn would
for a job that runs alone: of the (technique, batch) pairs that fit, the
one that trains the most tokens a second.  A pair fits if ``STEPS``
training steps of the job at the cell's sequence length peak below
``HEADROOM`` of the card's memory and the caching allocator never had
to free its cache and retry (a job at that edge slows and spreads from
step to step).  Each technique's batches are tried upwards until one
does not fit.  Each trial runs in a process of its own, so that one
trial's allocator state does not move the next one's.

    python3 saturn_bench/probe.py --config <name> --seq 4096 --batches 1 2 4

prints one JSON line a trial and then the choice.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
HEADROOM = 0.85
STEPS = 4            # the last two are timed
TECHNIQUES = ("ddp", "remat-offload")


def trial(config: str, technique: str, batch: int, seq: int) -> dict:
    """``STEPS`` steps of the job on cuda:0: the peak, the allocator's
    retries and the mean seconds of the last two steps."""
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from repro_torch.core.job import Job
    from repro_torch.core.library import ParallelismLibrary
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallelism.build import BuiltJob
    from saturn_bench import cells
    from saturn_bench.reference import params as ref_params
    config = cells.load_json(os.path.join(HERE, "configs", config + ".json"))
    cfg = cells.model_config(config)
    job = Job(cfg.name, cfg, batch, seq, 1000)
    plan = ParallelismLibrary().get(technique).plan(cfg, 1)
    built = BuiltJob(cfg, plan, job.opt_cfg, device="cuda:0")
    params = built.shard(ref_params.nest(ref_params.init(config, 0,
                                                         "cuda:0")))
    opt = init_opt_state(params)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda:0",
                           dtype=torch.int32)
    out = {"config": cfg.name, "technique": technique, "batch": batch,
           "seq": seq, "fits": False}
    try:
        for i in range(STEPS):
            if i == STEPS - 2:
                t0 = time.perf_counter()
            params, opt, m = built.step(params, opt,
                                        built.place_batch({"tokens": tokens}))
            float(m["loss"])
    except torch.OutOfMemoryError:
        out["peak_bytes"] = None
        return out
    step_s = (time.perf_counter() - t0) / 2
    peak = torch.cuda.max_memory_allocated(0)
    retries = torch.cuda.memory_stats(0)["num_alloc_retries"]
    total = torch.cuda.get_device_properties(0).total_memory
    out.update(step_s=step_s, tokens_per_s=batch * seq / step_s,
               peak_bytes=peak, total_bytes=total, alloc_retries=retries,
               fits=peak <= HEADROOM * total and retries == 0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--batches", type=int, nargs="+", required=True)
    ap.add_argument("--one", nargs=2, metavar=("TECHNIQUE", "BATCH"))
    args = ap.parse_args()
    if args.one:
        print(json.dumps(trial(args.config, args.one[0], int(args.one[1]),
                               args.seq)))
        return 0
    fits = []
    for technique in TECHNIQUES:
        for batch in sorted(args.batches):
            proc = subprocess.run(
                [sys.executable, __file__, "--config", args.config, "--seq",
                 str(args.seq), "--batches", "1", "--one", technique,
                 str(batch)], capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            res = json.loads(lines[-1]) if proc.returncode == 0 and lines \
                else {"technique": technique, "batch": batch, "fits": False,
                      "error": proc.stderr[-400:]}
            print(json.dumps(res), flush=True)
            if not res["fits"]:
                break
            fits.append(res)
    best = max(fits, key=lambda r: r["tokens_per_s"], default=None)
    print(json.dumps({"choice": best and {"technique": best["technique"],
                                          "batch": best["batch"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
