"""Quickstart on the PyTorch port: the Saturn workflow in ~40 lines
(paper Fig. 1 API), as ``examples/quickstart.py`` runs it on the JAX
package.

    PYTHONPATH=src python examples/torch_quickstart.py

Registers a custom technique, submits a small model-selection workload,
profiles it (Trial Runner), solves the joint MILP, and simulates
execution vs Current Practice.  No card is needed: the Trial Runner
traces each trial's step on meta tensors on the host CPU (72 analyses;
each time loop of the xlstm-125m jobs is counted once and charged for
its trips), about a minute in all on two cores.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.core.api import SaturnSession
from repro_torch.core.baselines import CurrentPractice
from repro_torch.core.job import ClusterSpec, hpo_grid
from repro_torch.parallelism.base import Plan, Technique


# -- users can extend the Parallelism Library with the 2-function API
class MyBatchShard(Technique):
    name = "my-batch-shard"

    def search_space(self, cfg, n):          # function 1: validity
        return n in (2, 4)

    def plan(self, cfg, n):                  # function 2: how to execute
        return Plan(self.name, n, (("data", n),), {"batch": "data"})


def main():
    cluster = ClusterSpec(nodes=1, gpus_per_node=8)
    sess = SaturnSession(cluster)
    sess.register_technique(MyBatchShard())

    jobs = hpo_grid(
        [("small-lm", get_config("xlstm-125m")),
         ("big-lm", get_config("h2o-danube-3-4b"))],
        lrs=[1e-4, 1e-3], batch_sizes=[16, 32],
        seq_len=1024, total_steps=1000)
    sess.submit(jobs)

    # Trial Runner: trials at anchor counts only; the performance model
    # interpolates every other count for the Solver
    sess.profile(mode="analytic", strategy="interpolate")
    base = sess.run(policy=CurrentPractice())
    sat = sess.run()                         # Saturn: joint MILP + introspection

    print(f"\njobs: {len(jobs)}  cluster: {cluster.total_gpus} GPUs")
    print(f"current practice : {base.makespan_s / 3600:.2f} h")
    print(f"saturn           : {sat.makespan_s / 3600:.2f} h "
          f"({100 * (1 - sat.makespan_s / base.makespan_s):.0f}% lower, "
          f"{sat.replans} replans)")
    for a in sorted({(g.job, g.technique, g.n_gpus) for g in sat.gantt
                     if g.kind == 'run'}):
        print(f"  {a[0]:28s} -> {a[1]:>6s} x{a[2]} GPUs")


if __name__ == "__main__":
    main()
