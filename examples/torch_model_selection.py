"""Model selection at paper scale on the PyTorch port: the Table-1
workload (2 workloads x 12-job HPO grids) under all five policies on 1-
and 2-node clusters, as ``examples/model_selection.py`` runs it on the
JAX package.

    PYTHONPATH=src python examples/torch_model_selection.py [--nodes 1]
        [--placement flat|node] [--online] [--arrival-gap 600]

--placement node routes Saturn through the node-locality MILP and makes
the runtime's NodeAware backend enforce per-node capacity (single-node
configs never straddle nodes).  --online staggers job arrivals by
--arrival-gap seconds: the dynamic model-selection scenario the paper's
introspection mechanism is built for — policies replan as jobs arrive.
No card is needed: the Trial Runner traces each trial's step on meta
tensors on the host CPU (each time loop of the xLSTM jobs counted once
and charged for its trips), about a minute in all on two cores at the
default flags.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.core.baselines import (CurrentPractice, Optimus,
                                        OptimusDynamic, RandomPolicy,
                                        SaturnPolicy)
from repro_torch.core.executor import simulate
from repro_torch.core.job import ClusterSpec, hpo_grid
from repro_torch.core.library import ParallelismLibrary
from repro_torch.core.profiler import HARDWARE, TrialRunner


def paper_workloads():
    """The paper's Table-1 model-selection grids on the assigned
    architecture pool, as ``benchmarks/run.py:paper_workloads`` builds
    them (GPT-2/GPT-J -> xlstm-125m/olmoe-1b-7b; ViT-G/ResNet-200 ->
    gemma3-4b/internvl2-1b)."""
    wikitext = hpo_grid(
        [("xlstm-125m", get_config("xlstm-125m")),
         ("olmoe-1b-7b", get_config("olmoe-1b-7b"))],
        lrs=[1e-5, 1e-4, 1e-3], batch_sizes=[16, 32],
        seq_len=1024, total_steps=1500,
        steps_scale={"xlstm-125m": 1.0, "olmoe-1b-7b": 1.0})
    imagenet = hpo_grid(
        [("gemma3-4b", get_config("gemma3-4b")),
         ("internvl2-1b", get_config("internvl2-1b"))],
        lrs=[1e-5, 1e-4, 1e-3], batch_sizes=[64, 128],
        seq_len=256, total_steps=2000)
    return {"wikitext": wikitext, "imagenet": imagenet}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--workload", default="wikitext",
                    choices=["wikitext", "imagenet"])
    ap.add_argument("--placement", default="flat", choices=["flat", "node"])
    ap.add_argument("--online", action="store_true",
                    help="stagger job arrivals (online model selection)")
    ap.add_argument("--arrival-gap", type=float, default=600.0,
                    help="seconds between successive arrivals with --online")
    ap.add_argument("--profile-strategy", default="interpolate",
                    choices=["interpolate", "exhaustive"],
                    help="interpolate: anchor trials + throughput curves "
                         "over the dense 1..G grid (paper's <5%% overhead "
                         "budget); exhaustive: profile every combo")
    args = ap.parse_args()

    jobs = paper_workloads()[args.workload]
    if args.online:
        jobs = [dataclasses.replace(j, arrival_s=i * args.arrival_gap)
                for i, j in enumerate(jobs)]
    cluster = ClusterSpec(nodes=args.nodes, gpus_per_node=8,
                          placement=args.placement)
    lib = ParallelismLibrary()
    runner = TrialRunner(lib, HARDWARE["a100"])
    if args.profile_strategy == "interpolate":
        # dense solver grid, sparse (anchor-only) real profiling
        counts = list(range(1, cluster.total_gpus + 1))
    else:
        counts = [1, 2, 4, 8] + ([16] if args.nodes == 2 else [])
    profiles = runner.profile_all(jobs, counts, mode="analytic",
                                  strategy=args.profile_strategy)

    mode = "online" if args.online else "offline"
    print(f"{args.workload}: {len(jobs)} jobs, {cluster.total_gpus} GPUs, "
          f"{args.placement} placement, {mode}")
    results = {}
    for pol in (CurrentPractice(), RandomPolicy(0), Optimus(),
                OptimusDynamic(), SaturnPolicy(time_limit_s=15)):
        res = simulate(jobs, pol, profiles, cluster,
                       introspect_every_s=600 if pol.dynamic else None)
        results[pol.name] = res
        print(f"  {pol.name:18s} {res.makespan_s / 3600:6.2f} h   "
              f"util={res.utilization(cluster):.2f} "
              f"replans={res.replans} restarts={res.restarts}")

    sat = results["saturn"]
    print("\nSaturn Gantt (first 12 segments) — note the mixed"
          " parallelisms/allocations:")
    for g in sorted(sat.gantt, key=lambda g: g.start_s)[:12]:
        if g.kind == "run":
            devs = f" gpus={_ranges(g.devices)}" if g.devices else ""
            print(f"  t={g.start_s / 3600:6.2f}h..{g.end_s / 3600:6.2f}h  "
                  f"{g.job:26s} {g.technique:>6s} x{g.n_gpus}{devs}")


def _ranges(devices):
    """Collapse a device set to 'a-b,c-d' (NodeAware placements need not
    be contiguous)."""
    out, run = [], [devices[0], devices[0]]
    for d in devices[1:]:
        if d == run[1] + 1:
            run[1] = d
        else:
            out.append(run)
            run = [d, d]
    out.append(run)
    return ",".join(f"{a}-{b}" if a != b else f"{a}" for a, b in out)


if __name__ == "__main__":
    main()
