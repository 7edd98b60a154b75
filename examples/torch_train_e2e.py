"""End-to-end driver on the PyTorch port: REALLY train xLSTM variants
through the full session-driven Saturn pipeline — empirical Trial-Runner
profiling, MILP plan, and the cluster runtime executing the Schedule IR
on the LocalTorchBackend: concurrent per-job device slices, wall-clock
introspection replans with measured-throughput feedback, and
checkpointed preemption/resume — as ``examples/train_e2e.py`` runs it
on the JAX package.

    PYTHONPATH=src python examples/torch_train_e2e.py --steps 300 --size small

--size full uses the real xlstm-125m config; --size small uses a ~12M
same-family variant for quick runs.  --device cuda (the default) trains
on the cards: --gpus N takes the first N (every card by default);
--device cpu stands the CPU in for each of --gpus N GPUs (2 by
default).  A job of g > 1 GPUs trains as g processes of a group.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core.api import SaturnSession
from repro_torch.core.job import ClusterSpec, Job
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", default="small", choices=["small", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--gpus", type=int, default=None,
                    help="cluster size: the first N cards (default every "
                         "card), or N CPU slots with --device cpu "
                         "(default 2)")
    ap.add_argument("--introspect-s", type=float, default=60.0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "saturn_torch_e2e"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    dev = resolve_device(args.device)
    gpus = args.gpus or (torch.cuda.device_count() if dev.type == "cuda"
                         else 2)
    base = get_config("xlstm-125m")
    if args.size == "small":
        # ~12M same-family variant — tractable on the CPU for a few
        # hundred steps; --size full runs the real 125M config
        cfg = dataclasses.replace(base, num_layers=4, d_model=256,
                                  num_heads=4, head_dim=64,
                                  name="xlstm-12m")
    else:
        cfg = base
    jobs = [Job(f"{cfg.name}-lr{lr:g}", cfg, args.batch, args.seq,
                total_steps=args.steps, lr=lr, seed=i)
            for i, (lr) in enumerate([3e-4, 1e-3])]

    cluster = ClusterSpec(nodes=1, gpus_per_node=gpus,
                          restart_cost_s=2.0)
    sess = SaturnSession(cluster, device=args.device)
    sess.submit(jobs)

    print("== Trial Runner (empirical, real minibatches) ==")
    t0 = time.time()
    profiles = sess.profile(mode="empirical", strategy="exhaustive")
    for (name, tech, g), p in sorted(profiles.items()):
        if p.feasible:
            print(f"  {name} {tech} x{g}: {p.step_time_s * 1e3:.0f} ms/step")
    print(f"  ({time.time() - t0:.0f}s)")

    print("== Solver + LocalTorchBackend (real training, checkpointed) ==")
    t0 = time.time()
    res = sess.run(backend="local", ckpt_dir=args.ckpt_dir,
                   introspect_every_s=args.introspect_s, time_limit_s=10)
    print(f"  makespan {res.makespan_s:.0f}s (wall {time.time() - t0:.0f}s) "
          f"replans={res.replans} restarts={res.restarts}")
    by_name = {j.name: j for j in jobs}
    for name, st in sorted((k, v) for k, v in res.stats.items()
                           if k in by_name):
        segs = st["segments"]
        total = sum(s["steps"] for s in segs)
        first = st["losses"][0][1] if st["losses"] else float("nan")
        last = st["losses"][-1][1] if st["losses"] else float("nan")
        print(f"  {name}: {total} steps in {len(segs)} segment(s), "
              f"loss {first:.3f} -> {last:.3f}, "
              + ", ".join(f"{s['technique']}x{s['n_gpus']}"
                          f"@{s['start_step']}" for s in segs))
        assert total >= by_name[name].total_steps


if __name__ == "__main__":
    main()
