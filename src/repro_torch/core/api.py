"""SaturnSession — the user-facing facade (paper Fig. 1B API):

    sess = SaturnSession(cluster)
    sess.register_technique(MyTechnique())     # Parallelism Library
    sess.submit(jobs)                          # model selection workload
    sess.submit(more_jobs, arrival_s=3600.0)   # ...or staggered arrivals
    sess.profile()                             # Trial Runner
    result = sess.run()                        # Solver + cluster runtime

Execution goes through the event-driven cluster runtime: placement is
chosen by ``ClusterSpec.placement`` ("flat" pool or "node"-aware), jobs
with ``arrival_s > 0`` enter the system online, and dynamic policies
replan on arrivals and introspection ticks with real restart penalties.

``device`` ("cuda" by default) is where empirical trials and
``run(backend="local")`` train: every card for "cuda" (a run without a
card raises), or the CPU standing in for each of the cluster's GPUs for
"cpu".
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import torch

from .baselines import SaturnPolicy
from .executor import simulate
from .job import ClusterSpec, Job, ServeJob
from .library import ParallelismLibrary
from .profiler import HARDWARE, HardwareSpec, TrialRunner
from .runtime import SimResult
from .schedule import Policy


class SaturnSession:
    def __init__(self, cluster: ClusterSpec,
                 hardware: HardwareSpec = HARDWARE["a100"],
                 cache_path: Optional[str] = None,
                 library: Optional[ParallelismLibrary] = None,
                 device="cuda"):
        self.cluster = cluster
        self.library = library or ParallelismLibrary()
        self.device = device
        self.runner = TrialRunner(self.library, hardware, cache_path,
                                  device=device, devices=self._devices())
        # mixed fleets: derive per-class hardware (speed_hint-scaled
        # rates, per-class HBM) so trials land at realistic speeds
        for dc in cluster.device_classes:
            self.runner.register_class(dc)
        self.jobs: List[Job] = []
        self.serves: List[ServeJob] = []
        # a PerfModel (strategy="interpolate") or legacy profile dict
        self.profiles = {}

    def _devices(self):
        """The device list for trials and local runs: on the CPU, the
        CPU once per GPU of the cluster; a named card alone; for a bare
        "cuda", None (every card)."""
        dev = torch.device(self.device)
        if dev.type == "cpu":
            return ["cpu"] * self.cluster.total_gpus
        return None if dev.index is None else [dev]

    # ------------------------------------------------- Parallelism Library
    def register_technique(self, technique):
        return self.library.register(technique)

    # ----------------------------------------------------------- workload
    def submit(self, jobs: Sequence[Job],
               arrival_s: Optional[Union[float, Sequence[float]]] = None):
        """Add jobs to the workload.

        ``arrival_s`` stamps submission times for online scenarios: a
        scalar applies to every job in this batch, a sequence gives one
        arrival per job.  Omitted, each job keeps its own ``arrival_s``
        (0.0 for offline workloads).
        """
        jobs = list(jobs)
        if arrival_s is not None:
            if isinstance(arrival_s, (int, float)):
                arrivals = [float(arrival_s)] * len(jobs)
            else:
                arrivals = [float(a) for a in arrival_s]
                if len(arrivals) != len(jobs):
                    raise ValueError(
                        f"{len(arrivals)} arrivals for {len(jobs)} jobs")
            jobs = [dataclasses.replace(j, arrival_s=a)
                    for j, a in zip(jobs, arrivals)]
        self.jobs.extend(jobs)
        return jobs

    def submit_serving(self, serves: Sequence[ServeJob]):
        """Add serving workloads: each :class:`~repro_torch.core.job.ServeJob`
        is a model with a p99 latency SLO and a request-arrival trace
        (see :mod:`repro_torch.data.traffic`).  ``run()`` sizes a
        continuous-batching replica fleet per serve job — device class
        and per-window replica count — and trains the sweep around the
        capacity the fleets hold."""
        serves = list(serves)
        self.serves.extend(serves)
        return serves

    def gpu_counts(self, dense: bool = False):
        """Candidate GPU counts: the geometric ladder (what gets real
        trials), or with ``dense`` every count 1..G (what the
        performance model evaluates for free).  On heterogeneous
        clusters G is the LARGEST class (a single allocation never
        straddles classes); profiling truncates per class."""
        if self.cluster.hetero:
            g = max(dc.total_gpus for dc in self.cluster.device_classes)
        else:
            g = self.cluster.total_gpus
        if dense:
            return list(range(1, g + 1))
        counts, c = [], 1
        while c <= g:
            counts.append(c)
            c *= 2
        if g not in counts:
            counts.append(g)
        return counts

    # --------------------------------------------------------- Trial Runner
    def profile(self, mode: str = "analytic",
                strategy: str = "interpolate",
                workers: Optional[int] = None,
                calibration_trials: int = 2,
                confidence_threshold: float = 0.3):
        """Run the Trial Runner over the submitted workload.

        ``strategy="interpolate"`` (default, the paper's <5%-overhead
        mechanism) runs real trials only at the geometric anchor counts
        and returns a curve-backed
        :class:`~repro_torch.core.perfmodel.PerfModel` covering EVERY count
        1..G — the Solver gets the dense allocation grid at the sparse
        profiling price.  ``strategy="exhaustive"`` profiles the
        geometric ladder directly and returns the legacy dict.
        ``strategy="roofline"`` and ``mode="analytic"`` read compiled
        HLO and raise ``NotImplementedError`` (ROADMAP A12).
        Napkin trials fan out across ``workers`` threads (auto by
        default); empirical trials always run serially.
        """
        self.profiles = self.runner.profile_all(
            self.jobs,
            self.gpu_counts(dense=(strategy in ("interpolate",
                                                "roofline"))),
            mode=mode, strategy=strategy, workers=workers,
            calibration_trials=calibration_trials,
            confidence_threshold=confidence_threshold,
            classes=(self.cluster.device_classes if self.cluster.hetero
                     else None))
        return self.profiles

    # ------------------------------------------------------ Solver + exec
    def run(self, policy: Optional[Policy] = None,
            introspect_every_s: Optional[float] = 600.0,
            noise_sigma: float = 0.1,
            placement: Optional[str] = None,
            n_slots: Optional[int] = None,
            time_limit_s: Optional[float] = None,
            mip_gap: Optional[float] = None,
            refine: Optional[bool] = None,
            incremental: Optional[bool] = None,
            objective: Optional[str] = None,
            solver: Optional[str] = None,
            backend: str = "sim",
            ckpt_dir: Optional[str] = None,
            chaos=None,
            serve_window_s: float = 60.0,
            serve_util_cap: float = 0.7,
            serve_adaptive: bool = True) -> SimResult:
        """Solve + execute on the cluster runtime.

        ``backend`` selects the execution substrate the one Schedule IR
        drives: ``"sim"`` (default) runs in virtual time on the
        :class:`~repro_torch.core.runtime.SimBackend`; ``"local"`` REALLY
        trains the models on this session's devices via
        :class:`~repro_torch.core.local_backend.LocalTorchBackend` —
        checkpointed preemption, wall-clock introspection intervals, and
        measured step times fed back into the replans; ``"process"``,
        which isolates every job in a supervised worker process, is not
        ported yet and raises ``NotImplementedError`` (ROADMAP A6).
        ``ckpt_dir`` (local) pins where checkpoints land.

        ``placement`` overrides ``cluster.placement`` for this run.

        The solver knobs (``n_slots``, ``time_limit_s``, ``mip_gap``,
        ``refine``, ``incremental``, ``objective``, ``solver``)
        configure the
        default :class:`SaturnPolicy` this call constructs; passing them
        together with an explicit ``policy`` is an error — configure
        the policy directly instead of having knobs silently ignored.
        ``objective`` selects what the MILP minimizes ("makespan",
        "weighted_completion", "tardiness" or "fair_share" — see
        ``repro_torch.core.solver.OBJECTIVES``).  ``solver="portfolio"``
        races the MILP against the interval-time LNS per (re)plan
        (first to the ``mip_gap`` target wins) — per-plan engine
        telemetry lands in ``result.stats["solver"]``.

        ``chaos`` injects a :class:`~repro_torch.core.chaos.ChaosTrace` —
        seeded node failures, spot revocations/grants and capacity
        resizes — into the run; killed launches salvage their last
        periodic checkpoint and dynamic policies replan on the new
        capacity.

        Serving (``submit_serving``): each serve job gets an SLO-sized
        continuous-batching fleet re-planned every ``serve_window_s``
        (``serve_adaptive=False`` holds peak provisioning — the static
        partition baseline); fleet growth may evict training launches,
        and per-window p50/p99/attainment land in
        ``result.stats["serving"]``.  ``serve_util_cap`` is the target
        utilization headroom per replica.
        """
        knobs = {k: v for k, v in (("n_slots", n_slots),
                                   ("time_limit_s", time_limit_s),
                                   ("mip_gap", mip_gap),
                                   ("refine", refine),
                                   ("incremental", incremental),
                                   ("objective", objective),
                                   ("solver", solver))
                 if v is not None}
        if policy is not None and knobs:
            raise ValueError(
                f"solver knobs {sorted(knobs)} only apply to the default "
                f"SaturnPolicy; configure your policy directly")
        if backend not in ("sim", "local", "process"):
            raise ValueError(f"unknown execution backend {backend!r}; "
                             f"expected 'sim', 'local' or 'process'")
        if backend == "process":
            raise NotImplementedError(
                "backend='process' (supervised worker processes) is not "
                "ported yet (ROADMAP A6); use backend='local'")
        if ckpt_dir is not None and backend == "sim":
            raise ValueError(
                "ckpt_dir only applies to backend='local'/'process'")
        if not self.profiles:
            self.profile()
        policy = policy or SaturnPolicy(**knobs)
        cluster = self.cluster
        if placement is not None and placement != cluster.placement:
            # the policy must see the same placement the runtime enforces
            # (node-aware Saturn switches MILPs on it)
            cluster = dataclasses.replace(cluster, placement=placement)
        exec_backend = None
        if backend == "local":
            from .local_backend import LocalTorchBackend
            exec_backend = LocalTorchBackend(self.library, ckpt_dir=ckpt_dir,
                                             devices=self._devices())
        profiles, fleets = self.profiles, None
        if self.serves:
            from ..serving.fleet import FleetManager, serve_profiles
            from .perfmodel import MergedProfiles
            sp = serve_profiles(self.serves, cluster)
            profiles = (MergedProfiles(sp, profiles)
                        if not isinstance(profiles, dict)
                        else {**profiles, **sp})
            fleets = FleetManager(self.serves, cluster,
                                  window_s=serve_window_s,
                                  util_cap=serve_util_cap,
                                  adaptive=serve_adaptive)
        return simulate(self.jobs, policy, profiles, cluster,
                        introspect_every_s=introspect_every_s
                        if policy.dynamic else None,
                        noise_sigma=noise_sigma,
                        exec_backend=exec_backend, chaos=chaos,
                        fleets=fleets)
