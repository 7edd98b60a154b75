"""Cluster execution front-end.

``simulate()`` is now a thin compatibility wrapper over the event-driven
cluster runtime (:mod:`.runtime`): Schedule IR plans, pluggable
placement (flat pool / node-aware), online arrivals, and real preemption
with restart penalties.  ``simulate_legacy()`` keeps the original
closed-form while-loop (with its restart-penalty accounting bug fixed)
as an equivalence comparator for the runtime's flat-pool path.

``LocalRunner`` really trains models on this machine for the end-to-end
examples; wall-times feed back as profiles.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .job import ClusterSpec, Job
from .profiler import Profile
# Re-exports: these types historically lived here; the runtime owns them
# now but existing callers keep importing from executor.
from .runtime import (GanttEntry, SimResult, _noise_factors,  # noqa: F401
                      simulate_runtime)
from .schedule import Policy, Schedule  # noqa: F401


def simulate(jobs: List[Job], policy: Policy,
             profiles: Dict[Tuple[str, str, int], Profile],
             cluster: ClusterSpec, *,
             introspect_every_s: Optional[float] = None,
             noise_sigma: float = 0.1, noise_seed: int = 0,
             max_events: int = 100000,
             placement: Optional[str] = None,
             exec_backend=None, chaos=None, fleets=None) -> SimResult:
    """Compatibility wrapper: run on the event-driven runtime.

    ``placement`` overrides ``cluster.placement`` ("flat" keeps the
    historical single-pool behavior; "node" enforces node locality).
    ``exec_backend`` selects the execution substrate (default: the
    virtual-time :class:`~repro_torch.core.runtime.SimBackend`; pass a
    :class:`~repro_torch.core.local_backend.LocalTorchBackend` to really train).
    ``chaos`` injects a :class:`~repro_torch.core.chaos.ChaosTrace` of cluster
    events (failures, spot churn, resizes) into the run.  ``fleets``
    runs serving fleets alongside training (a
    :class:`~repro_torch.serving.fleet.FleetManager`).
    """
    import dataclasses as _dc
    if placement is not None and \
            placement != getattr(cluster, "placement", "flat"):
        # the policy must see the same placement the runtime enforces
        # (node-aware Saturn switches MILPs on cluster.placement)
        cluster = _dc.replace(cluster, placement=placement)
    return simulate_runtime(jobs, policy, profiles, cluster,
                            introspect_every_s=introspect_every_s,
                            noise_sigma=noise_sigma, noise_seed=noise_seed,
                            max_events=max_events,
                            exec_backend=exec_backend, chaos=chaos,
                            fleets=fleets)


def simulate_legacy(jobs: List[Job], policy: Policy,
                    profiles: Dict[Tuple[str, str, int], Profile],
                    cluster: ClusterSpec, *,
                    introspect_every_s: Optional[float] = None,
                    noise_sigma: float = 0.1, noise_seed: int = 0,
                    max_events: int = 100000) -> SimResult:
    """The original flat-pool while-loop simulator.

    Kept as the reference implementation the runtime must match on
    offline flat-pool workloads.  The historical restart-penalty bug is
    fixed here too: a preempted job used to be re-admitted by
    ``start_fitting()`` at time ``t`` even though a restart Gantt entry
    through ``t + restart_cost_s`` was just recorded (double-booking the
    GPUs and understating dynamic policies' preemption cost).  Restarted
    jobs now only become admissible at ``t + restart_cost_s``.
    """
    import dataclasses as _dc

    @_dc.dataclass
    class _Running:
        job: Job
        technique: str
        n_gpus: int
        start_s: float
        true_step_s: float
        steps_at_start: int

    noise = _noise_factors(jobs, profiles, noise_seed, noise_sigma)

    def est_step(jname, tech, g):
        return profiles[(jname, tech, g)].step_time_s

    def true_step(jname, tech, g):
        return est_step(jname, tech, g) * noise[(jname, tech, g)]

    remaining = {j.name: j.total_steps for j in jobs}
    by_name = {j.name: j for j in jobs}
    waiting = [j.name for j in jobs]
    restart_ready: Dict[str, float] = {}     # job -> earliest relaunch time
    running: Dict[str, _Running] = {}
    free = cluster.total_gpus
    t = 0.0
    gantt: List[GanttEntry] = []
    replans = restarts = 0
    current_assign: Dict[str, Tuple[str, int]] = {}
    order = Schedule.coerce(policy.plan(
        jobs, dict(remaining), profiles, cluster, {})).to_tuples()
    replans += 1
    next_introspect = (introspect_every_s if introspect_every_s else math.inf)

    def settle(upto_t):
        for name, r in running.items():
            done = int((upto_t - r.start_s) / r.true_step_s)
            remaining[name] = max(0, r.steps_at_start - done)

    def start_fitting():
        nonlocal free
        started = True
        while started:
            started = False
            for (jname, tech, g) in order:
                if jname in waiting and g <= free and \
                        restart_ready.get(jname, 0.0) <= t + 1e-12:
                    st = true_step(jname, tech, g)
                    running[jname] = _Running(by_name[jname], tech, g, t,
                                              st, remaining[jname])
                    current_assign[jname] = (tech, g)
                    waiting.remove(jname)
                    free -= g
                    started = True
                    break

    start_fitting()
    events = 0
    while (waiting or running) and events < max_events:
        events += 1
        next_wake = min((restart_ready[n] for n in waiting
                         if restart_ready.get(n, 0.0) > t + 1e-12),
                        default=math.inf)
        if running:
            next_done_t, next_done = min(
                ((r.start_s + r.steps_at_start * r.true_step_s, name)
                 for name, r in running.items()), key=lambda x: x[0])
        else:
            next_done_t, next_done = math.inf, None
            if not math.isfinite(next_wake):
                raise RuntimeError(
                    f"deadlock: waiting={waiting} free={free} order={order}")
        if next_introspect < min(next_done_t, next_wake) - 1e-12:
            # ---- introspection point: re-solve on remaining work
            t = next_introspect
            next_introspect += introspect_every_s
            settle(t)
            if policy.dynamic:
                replans += 1
                new_order = Schedule.coerce(policy.plan(
                    jobs, dict(remaining), profiles, cluster,
                    dict(current_assign))).to_tuples()
                new_assign = {j: (tech, g) for j, tech, g in new_order}
                # restart running jobs whose assignment changed
                for name in list(running):
                    if name in new_assign and new_assign[name] != \
                            current_assign.get(name):
                        r = running.pop(name)
                        free += r.n_gpus
                        gantt.append(GanttEntry(name, r.technique, r.n_gpus,
                                                r.start_s, t))
                        # checkpoint + relaunch penalty: blocked until
                        # t + restart_cost_s
                        gantt.append(GanttEntry(name, "restart", 0, t,
                                                t + cluster.restart_cost_s,
                                                kind="restart"))
                        remaining[name] = max(1, remaining[name])
                        restart_ready[name] = t + cluster.restart_cost_s
                        waiting.append(name)
                        restarts += 1
                order = new_order
                start_fitting()
            continue
        if next_wake < next_done_t - 1e-12:
            # ---- a restarted job becomes admissible again
            t = next_wake
            start_fitting()
            continue
        # ---- completion event
        t = next_done_t
        settle(t)
        r = running.pop(next_done)
        remaining[next_done] = 0
        free += r.n_gpus
        gantt.append(GanttEntry(next_done, r.technique, r.n_gpus,
                                r.start_s, t))
        if policy.dynamic and policy.replan_on_completion and waiting:
            replans += 1
            order = Schedule.coerce(policy.plan(
                jobs, dict(remaining), profiles, cluster,
                dict(current_assign))).to_tuples()
        start_fitting()
    if events >= max_events:
        raise RuntimeError("simulate: event cap hit")
    return SimResult(policy.name, t, gantt, replans, restarts)


# --------------------------------------------------------------- local run

class LocalRunner:
    """Really execute a plan on this machine: jobs run in list order
    under their assigned technique, with checkpointing.  Used by the
    end-to-end examples; wall-times feed back as profiles.

    (The cluster runtime's real-execution path is
    :class:`~repro_torch.core.local_backend.LocalTorchBackend`, which runs
    the Schedule IR concurrently with preemption; this runner is the
    simple serial building block.)  ``cluster_devices`` defaults to every
    card; ``ckpt_dir`` to a fresh temporary directory.
    """

    def __init__(self, cluster_devices=None, ckpt_dir: Optional[str] = None):
        self.devices = cluster_devices
        self.ckpt_dir = ckpt_dir

    def run_job(self, job: Job, technique, n_devices: int, *,
                steps: Optional[int] = None, resume: bool = True):
        """Train ``job`` for ``steps`` (default: its remaining steps),
        resuming state AND data position from its checkpoint.

        The first step after (re)launch is the warm-up (cuBLAS handles,
        allocator growth); it is timed separately (``compile_s``) so
        ``wall_s`` / ``step_time_s`` hold pure training time.
        """
        import tempfile
        import time as _time

        import torch

        from ..checkpoint.store import load_training_state, save_checkpoint
        from ..data.synthetic import SyntheticLM
        from ..device import local_devices
        from ..parallelism.build import BuiltJob

        if self.ckpt_dir is None:
            self.ckpt_dir = tempfile.mkdtemp(prefix="saturn_ckpts_")
        devs = list(self.devices or local_devices("cuda"))[:n_devices]
        plan = technique.plan(job.cfg, n_devices)
        built = BuiltJob(job.cfg, plan, job.opt_cfg, device=devs[0])
        dev = built.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        params, opt = built.init(job.seed)
        start_step = 0
        path = f"{self.ckpt_dir}/{job.name}.npz"
        if resume:
            params, opt, start_step = load_training_state(path, params, opt)
        n = steps if steps is not None else job.total_steps - start_step
        data = SyntheticLM(job.cfg, seed=job.seed).batches(
            job.batch_size, job.seq_len, num_batches=n, skip=start_step,
            device=dev)
        m = {}
        compile_s = 0.0
        it = iter(data)
        first = next(it, None)
        if first is not None:
            t0 = _time.perf_counter()
            params, opt, m = built.step(params, opt,
                                        built.place_batch(first))
            sync()
            compile_s = _time.perf_counter() - t0
        t0 = _time.perf_counter()
        for b in it:
            params, opt, m = built.step(params, opt, built.place_batch(b))
        sync()
        dt = _time.perf_counter() - t0
        save_checkpoint(path, {"params": params, "opt": opt},
                        {"step": start_step + n,
                         "loss": float(m.get("loss", float("nan")))})
        # a single-step call cannot separate warm-up from compute: its
        # step time is unknowable, not compile_s — report it as such
        return {"job": job.name, "steps": n, "wall_s": dt,
                "compile_s": compile_s,
                "step_time_s": dt / (n - 1) if n > 1 else float("nan"),
                "loss": float(m.get("loss", float("nan"))),
                "done": start_step + n >= job.total_steps}
