"""ClusterState + the backend-agnostic event-driven execution engine.

The engine (:func:`execute_runtime`) owns everything a *scheduler
runtime* owns — the event queue, job phases, placement, replans with
preemption diffs, Gantt + per-device-class GPU-second accounting — and
delegates everything an *execution substrate* owns to an
:class:`ExecutionBackend`: launching a (job, technique, device-set)
choice, polling its progress, preempting it with a checkpoint, and the
meaning of the clock.  Two backends implement the protocol:

- :class:`SimBackend` — virtual time.  Step times are profile estimates
  x seeded noise, completions are computed exactly at launch, and the
  clock simply follows event timestamps.  This is bit-exact with the
  historical ``simulate()`` loop: ``simulate_runtime`` (the compat
  entry point) constructs one by default, and the legacy equivalence
  tests pin the contract.
- :class:`~repro_torch.core.local_backend.LocalTorchBackend` — real execution.
  Each launch starts an actual PyTorch training loop on the placement's
  device slice, completions are *predicted* events corrected against
  measured progress, preemption really checkpoints, and the clock is
  the wall clock.  Measured step times feed back into the profiles the
  policy replans over (the paper's introspection loop, for real).

Engine semantics (shared by both backends):

- jobs arrive at ``Job.arrival_s`` (online workloads) and policies
  replan on arrival batches;
- preempted jobs pay a REAL restart penalty: their GPUs are released at
  preemption time but the job is only admissible again when its
  :class:`RestartDone` event fires at ``t + restart_cost_s``;
- placement is pluggable (:mod:`.placement`): flat pool, node-aware, or
  per-device-class pools on heterogeneous clusters;
- every Gantt entry records the concrete device set (and device class)
  it occupied, and the engine asserts GPU-second conservation PER
  DEVICE CLASS before returning;
- replans are warm-start-capable: the engine hands the previous
  Schedule, the current time and the running set to
  :meth:`Policy.plan_incremental`;
- chaos (:mod:`.chaos`) injects cluster events through the same queue:
  failures/revocations shrink the elastic placement pool mid-run (a
  killed launch salvages its last periodic checkpoint), recoveries and
  spot grants grow it with fresh device ids, and each applied change
  triggers an incremental replan against a LIVE capacity view — with
  the same per-class conservation check holding throughout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from .chaos import (CapacityChange, ChaosTrace, NodeFailure, NodeRecovery,
                    RetryPolicy, SpotGrant, SpotRevoke, WorkerFailure,
                    WorkerFault)
from .events import (ClusterEvent, EventQueue, IntrospectionTick,
                     JobArrival, JobCompletion, RestartDone)
from .job import DEFAULT_CLASS, SERVE_TECH, ClusterSpec, Job
from .perfmodel import ObservedProfiles, profile_key, step_time_of
from .placement import (ClassPool, PlacementBackend, PlacementError,
                        make_backend)
from .profiler import Profile
from .schedule import Placement, Policy, Schedule


@dataclasses.dataclass
class GanttEntry:
    job: str
    technique: str
    n_gpus: int
    start_s: float
    end_s: float
    kind: str = "run"          # run | restart
    devices: Tuple[int, ...] = ()
    device_class: str = DEFAULT_CLASS


@dataclasses.dataclass
class SimResult:
    policy: str
    makespan_s: float
    gantt: List[GanttEntry]
    replans: int = 0
    restarts: int = 0
    failures: int = 0          # chaos: NodeFailure events that took devices
    # execution-backend extras (LocalTorchBackend fills per-job segment
    # stats: losses, measured step times, compile costs); {} for sim
    stats: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # supervision: detected worker failures (dead/hung workers, escaped
    # worker exceptions) routed through the retry machinery, and jobs
    # that exhausted their retry budget — quarantined with a recorded
    # reason instead of crashing or deadlocking the run
    worker_failures: int = 0
    quarantined: Dict[str, str] = dataclasses.field(default_factory=dict)

    def utilization(self, cluster: ClusterSpec) -> float:
        busy = sum((g.end_s - g.start_s) * g.n_gpus for g in self.gantt
                   if g.kind == "run")
        return busy / (self.makespan_s * cluster.total_gpus + 1e-9)


def _noise_factors(jobs, profiles, seed: int, sigma: float):
    """Seeded multiplicative drift between estimated and true step times.
    Iterates profiles in insertion order so legacy and runtime paths see
    identical factors."""
    rng = np.random.RandomState(seed)
    out = {}
    for key in profiles:
        out[key] = float(np.exp(rng.randn() * sigma))
    return out


@dataclasses.dataclass
class LaunchHandle:
    """One live launch: what the engine tracks between ``launch`` and
    completion/preemption.  Backends may subclass to carry substrate
    state (the sim keeps its true step time; the local backend keeps a
    worker thread)."""
    job: Job
    technique: str
    n_gpus: int
    placement: Placement
    start_s: float
    true_step_s: float
    steps_at_start: int
    token: int

    @property
    def device_class(self) -> str:
        return getattr(self.placement, "device_class", DEFAULT_CLASS)


# Backward-compat alias: the handle used to be the runtime-private
# ``_Running`` record.
_Running = LaunchHandle


class ExecutionBackend:
    """The launch / preempt-with-checkpoint / poll-progress / clock
    protocol between the engine and an execution substrate.

    ``exact_completions`` declares whether the :class:`JobCompletion`
    events this backend's launches schedule are exact (virtual time) or
    predictions the engine must verify against real progress when they
    fire.  ``virtual`` declares whether the clock is simulated (the
    engine never blocks) or real (``wait_until`` sleeps).
    """

    kind = "base"
    virtual = True
    exact_completions = True

    # ------------------------------------------------------------- setup
    def bind(self, jobs: List[Job], profiles, cluster: ClusterSpec) -> None:
        """Called once per run before any event is processed."""
        self._profiles = profiles
        self._cluster = cluster

    # ------------------------------------------------------------- clock
    def event_time(self, ev) -> float:
        """What the engine clock reads when ``ev`` is processed."""
        return ev.t

    def wait_until(self, t: float) -> None:
        """Block until the clock reaches ``t`` (real backends; may
        return early when a launch finishes).  Virtual clocks no-op."""

    def drain_finished(self) -> Tuple[LaunchHandle, ...]:
        """Launches that finished since the last drain (real backends
        deliver completions through here; exact backends through the
        events they scheduled at launch)."""
        return ()

    # --------------------------------------------------------- supervision
    def drain_failures(self) -> Tuple[Tuple[LaunchHandle, str], ...]:
        """``(handle, reason)`` pairs for launches whose workers failed
        since the last drain — a worker process that died, a worker
        that missed its heartbeat deadline, an exception that escaped a
        worker thread.  The engine synthesizes a
        :class:`~repro_torch.core.chaos.WorkerFailure` event per record and
        routes it through salvage → backoff → relaunch (or quarantine
        once the :attr:`retry_policy` budget is exhausted)."""
        return ()

    # relaunch policy for failed workers; engine falls back to the
    # defaults when a backend leaves this None
    retry_policy: Optional[RetryPolicy] = None

    def salvage(self, handle: LaunchHandle) -> int:
        """Steps of a FAILED launch that are durable (checkpointed on
        disk and loadable at relaunch).  The base answers 0 — a worker
        that died without supervision salvages nothing beyond the
        checkpoint it was launched from; backends with periodic durable
        checkpoints answer from their checkpoint-ack records."""
        return 0

    def inject_fault(self, fault: WorkerFault,
                     running: Dict[str, LaunchHandle], t: float) -> None:
        """Really hurt a live worker (SIGKILL / stall heartbeats /
        truncate its checkpoint) per an injected
        :class:`~repro_torch.core.chaos.WorkerFault`.  Only fault-capable
        backends (separate worker processes) support this."""
        raise RuntimeError(
            f"execution backend {self.kind!r} cannot inject worker "
            f"faults (kind={fault.kind!r}); use a process-isolated "
            f"backend such as ProcessTorchBackend")

    # ---------------------------------------------------------- estimates
    def est_step(self, job: str, tech: str, g: int,
                 device_class: Optional[str] = None) -> float:
        """Estimated step time (profiles / performance model).  Curve-
        backed models answer at ANY count, so introspection replans may
        pick counts nobody profiled."""
        return step_time_of(self._profiles, job, tech, g,
                            device_class=device_class)

    def planning_profiles(self):
        """The profile view policies plan over.  The sim returns the
        bound profiles untouched (identity matters: solver choice caches
        key on it); real backends overlay measured step times."""
        return self._profiles

    def serve_step_time(self, serve, device_class: Optional[str] = None
                        ) -> float:
        """Per-token engine step time of ONE serving replica of
        ``serve`` (a :class:`~repro_torch.core.job.ServeJob`) on
        ``device_class`` — the serving counterpart of :meth:`est_step`.
        The base answers from the bound profiles; real backends measure
        an actual :class:`~repro_torch.serving.engine.ContinuousBatchingEngine`."""
        return step_time_of(self._profiles, serve.name, SERVE_TECH,
                            serve.gpus_per_replica,
                            device_class=device_class)

    # ------------------------------------------------------ run lifecycle
    def launch(self, job: Job, entry, placement: Placement,
               device_class: str, remaining: int, t: float,
               token: int) -> LaunchHandle:
        raise NotImplementedError

    def eta(self, handle: LaunchHandle) -> float:
        """(Predicted) completion time of a launch."""
        raise NotImplementedError

    def steps_done(self, handle: LaunchHandle, upto_t: float) -> int:
        """Poll progress: steps finished since this launch started."""
        raise NotImplementedError

    def is_finished(self, handle: LaunchHandle) -> bool:
        """Whether the launch has really completed (real backends)."""
        return True

    def preempt(self, handle: LaunchHandle, t: float) -> int:
        """Stop a launch, checkpointing its state; returns the steps it
        completed.  The engine releases devices and charges the restart
        penalty."""
        raise NotImplementedError

    def complete(self, handle: LaunchHandle, t: float) -> None:
        """Normal-completion cleanup (join workers, record stats)."""

    def result_stats(self) -> Dict[str, dict]:
        """Per-job execution stats for :class:`SimResult` (may be {})."""
        return {}


class SimBackend(ExecutionBackend):
    """Virtual-time execution: estimate x seeded noise, exact completion
    events, instant clock.  Bit-exact with the historical ``simulate()``
    while-loop (the runtime/legacy equivalence tests pin this)."""

    kind = "sim"
    virtual = True
    exact_completions = True

    def __init__(self, noise_sigma: float = 0.1, noise_seed: int = 0):
        self.noise_sigma = noise_sigma
        self.noise_seed = noise_seed

    def bind(self, jobs, profiles, cluster) -> None:
        super().bind(jobs, profiles, cluster)
        self._noise = _noise_factors(jobs, profiles, self.noise_seed,
                                     self.noise_sigma)

    def _true_step(self, job: str, tech: str, g: int,
                   device_class: Optional[str]) -> float:
        key = profile_key(self._profiles, job, tech, g, device_class)
        return self.est_step(job, tech, g, device_class) * \
            self._noise.get(key, 1.0)

    def launch(self, job, entry, placement, device_class, remaining, t,
               token) -> LaunchHandle:
        st = self._true_step(job.name, entry.technique, entry.n_gpus,
                             device_class)
        return LaunchHandle(job, entry.technique, entry.n_gpus, placement,
                            t, st, remaining, token)

    def eta(self, handle: LaunchHandle) -> float:
        return handle.start_s + handle.steps_at_start * handle.true_step_s

    def steps_done(self, handle: LaunchHandle, upto_t: float) -> int:
        return int((upto_t - handle.start_s) / handle.true_step_s)

    def preempt(self, handle: LaunchHandle, t: float) -> int:
        return self.steps_done(handle, t)

    def serve_step_time(self, serve, device_class=None) -> float:
        """Serving step times drift with the same seeded noise training
        steps do — the "measured" value the fleet manager observes."""
        return self._true_step(serve.name, SERVE_TECH,
                               serve.gpus_per_replica, device_class)


def verify_conservation(state: "ClusterState") -> None:
    """GPU-second conservation, per device class.

    Reconciles the launch-side allocation bookkeeping (token -> launch
    time / size / class, written in ``start_fitting`` from the actual
    Placement) against the release-side Gantt segments (written from the
    :class:`LaunchHandle`), and both against the concrete device ids
    those segments claim.  A device double-booked within its class, a
    segment whose devices belong to a different class than recorded, a
    launch whose placement was never released, or busy-seconds leaking
    from one class to another all fail here — even when the GLOBAL
    totals happen to balance out.
    """
    if state._alloc_open:
        raise RuntimeError(
            f"conservation: {len(state._alloc_open)} allocation(s) never "
            f"released: {sorted(state._alloc_open)}")
    runs = [g for g in state.gantt if g.kind == "run"]
    per_class: Dict[str, float] = {}
    by_dev: Dict[int, List[Tuple[float, float, str, str]]] = {}
    for g in runs:
        if len(set(g.devices)) != g.n_gpus:
            raise RuntimeError(
                f"conservation: {g.job} records {g.n_gpus} GPUs but "
                f"{len(set(g.devices))} distinct devices")
        per_class[g.device_class] = per_class.get(g.device_class, 0.0) \
            + (g.end_s - g.start_s) * g.n_gpus
        for d in g.devices:
            dc = state.backend.class_of(d)
            if dc != g.device_class:
                raise RuntimeError(
                    f"conservation: {g.job} recorded class "
                    f"{g.device_class!r} but device {d} belongs to {dc!r}")
            by_dev.setdefault(d, []).append(
                (g.start_s, g.end_s, g.job, g.device_class))
    classes = set(per_class) | set(state.busy_gpu_s)
    for dc in classes:
        a = per_class.get(dc, 0.0)
        b = state.busy_gpu_s.get(dc, 0.0)
        if abs(a - b) > 1e-6 * max(1.0, a, b):
            raise RuntimeError(
                f"conservation: class {dc!r} gantt={a:.6f} GPU-s vs "
                f"accounted={b:.6f} GPU-s")
    for d, ivs in by_dev.items():
        ivs.sort()
        for (s1, e1, j1, _), (s2, e2, j2, _) in zip(ivs, ivs[1:]):
            if e1 > s2 + 1e-9:
                raise RuntimeError(
                    f"conservation: device {d} double-booked: "
                    f"{j1}[{s1},{e1}] overlaps {j2}[{s2},{e2}]")


class ClusterState:
    """Mutable runtime state: job phases, remaining work, live launch
    handles, the Gantt log under construction, and per-device-class
    GPU-second accounting (the runtime's conservation invariant)."""

    def __init__(self, jobs: List[Job], backend: PlacementBackend):
        self.by_name: Dict[str, Job] = {j.name: j for j in jobs}
        self.remaining: Dict[str, int] = {j.name: j.total_steps for j in jobs}
        self.arrived: set = set()
        self.waiting: List[str] = []
        self.restarting: set = set()
        self.quarantined: Dict[str, str] = {}    # job -> recorded reason
        self.running: Dict[str, LaunchHandle] = {}
        self.backend = backend
        self.gantt: List[GanttEntry] = []
        self.current_assign: Dict[str, Tuple] = {}
        self.busy_gpu_s: Dict[str, float] = {}   # device class -> GPU-seconds
        self._alloc_open: Dict[int, Tuple[float, int, str]] = {}
        self.t = 0.0

    def note_alloc(self, token: int, t: float, n_gpus: int,
                   device_class: str) -> None:
        """Record an allocation at LAUNCH time.  This bookkeeping is
        written on the launch path (start_fitting), independently of the
        Gantt entries written on the release paths, so the conservation
        check reconciles two genuinely distinct records."""
        self._alloc_open[token] = (t, n_gpus, device_class)

    def close_alloc(self, token: int, end_s: float) -> None:
        """Close an allocation at release time and charge its class."""
        t0, n, dc = self._alloc_open.pop(token)
        self.busy_gpu_s[dc] = self.busy_gpu_s.get(dc, 0.0) \
            + (end_s - t0) * n

    def log_run(self, name: str, r: LaunchHandle, end_s: float) -> None:
        """Close a run segment: Gantt entry + launch-side accounting."""
        self.close_alloc(r.token, end_s)
        self.gantt.append(GanttEntry(
            name, r.technique, r.n_gpus, r.start_s, end_s,
            devices=r.placement.devices, device_class=r.device_class))

    def live_jobs(self) -> List[Job]:
        """Arrived, unfinished jobs (running, waiting, or restarting) —
        what planners plan over.  Quarantined jobs are out of the
        workload: the rest of the sweep replans onto the surviving
        capacity without them."""
        return [self.by_name[n] for n in self.by_name
                if n in self.arrived and self.remaining[n] > 0
                and n not in self.quarantined]

    def all_done(self) -> bool:
        """Every job finished its budget or was quarantined (a
        quarantined job is RESOLVED, not silently dropped: its recorded
        reason rides ``SimResult.quarantined``)."""
        return all(v == 0 for n, v in self.remaining.items()
                   if n not in self.quarantined)


def execute_runtime(jobs: List[Job], policy: Policy,
                    profiles: Dict[Tuple[str, str, int], Profile],
                    cluster: ClusterSpec, *,
                    exec_backend: ExecutionBackend,
                    introspect_every_s: Optional[float] = None,
                    max_events: int = 100000,
                    backend: Optional[PlacementBackend] = None,
                    chaos: Optional[ChaosTrace] = None,
                    fleets=None) -> SimResult:
    """Run ``jobs`` under ``policy`` on the event-driven engine, with
    execution delegated to ``exec_backend`` (sim or real).

    ``chaos`` injects a :class:`~repro_torch.core.chaos.ChaosTrace` of cluster
    events: failures/revocations shrink the placement pool mid-run
    (killing launches on dead devices, which salvage their last periodic
    checkpoint), recoveries/grants grow it with fresh device ids, and
    every applied change triggers an incremental replan for dynamic
    policies.  Requires an elastic placement backend (flat or per-class
    pools).  Per-class GPU-second conservation is verified at the end
    exactly as in the undisturbed case.

    ``fleets`` (a :class:`~repro_torch.serving.fleet.FleetManager`) runs
    serving fleets alongside training: replicas hold real placement-pool
    device blocks (Gantt segments, conservation accounting), are resized
    at introspection ticks as the traffic trace shifts — growth may
    EVICT training launches, which pay the usual restart penalty —
    and measured replica step times feed back into the profile view
    replans plan over.  Per-fleet per-window latency/SLO stats land in
    ``SimResult.stats["serving"]``."""
    backend = backend or make_backend(cluster)
    if chaos is not None and not backend.supports_elasticity and \
            any(not isinstance(e, WorkerFault) for e in chaos):
        # WorkerFaults never touch the placement pool, so a trace made
        # only of them runs on any backend
        raise ValueError(
            f"chaos injection needs an elastic placement backend; "
            f"{backend.kind!r} does not support shrink/grow")
    if fleets is not None:
        if backend.kind == "node":
            raise ValueError("serving fleets require flat or class "
                             "placement (node-aware pools cannot carve "
                             "replica blocks)")
        if not introspect_every_s:
            introspect_every_s = fleets.window_s
        fleets.plans(profiles)
    exec_backend.bind(jobs, profiles, cluster)
    state = ClusterState(jobs, backend)
    q = EventQueue()
    for j in jobs:
        q.push(JobArrival(max(0.0, getattr(j, "arrival_s", 0.0)), j))
    if introspect_every_s:
        q.push(IntrospectionTick(introspect_every_s))
    if chaos is not None:
        for cev in chaos:
            q.push(cev)

    order = Schedule([])
    replans = 0
    restarts = 0
    failures = 0
    solver_log: List[dict] = []   # per-(re)plan telemetry -> stats["solver"]
    worker_failures = 0
    retry = getattr(exec_backend, "retry_policy", None) or RetryPolicy()
    fail_counts: Dict[str, int] = {}   # job -> detected failures so far
    launch_tokens = {}            # job -> token of its current launch
    next_token = [0]

    def settle(upto_t: float) -> None:
        """Account finished steps for running jobs up to ``upto_t``
        (sim: computed from true step times; real: polled counters)."""
        for name, h in state.running.items():
            done = exec_backend.steps_done(h, upto_t)
            state.remaining[name] = max(0, h.steps_at_start - done)

    # ------------------------------------------- serving-fleet plumbing
    def _fleet_free(dclass: str) -> int:
        if isinstance(backend, ClassPool):
            return backend.free_in(dclass)
        return backend.free_gpus

    def _fleet_evict(n_gpus: int, dclass: str, t: float) -> None:
        """Free capacity for fleet growth by preempting training
        launches (largest first, same class) — serving's SLO outranks
        sweep throughput, so training pays the restart penalty."""
        nonlocal restarts
        victims = sorted(
            (h for h in state.running.values()
             if not isinstance(backend, ClassPool)
             or h.device_class == dclass),
            key=lambda h: -h.n_gpus)
        for h in victims:
            if _fleet_free(dclass) >= n_gpus:
                break
            name = h.job.name
            state.running.pop(name)
            done = exec_backend.preempt(h, t)
            backend.release(h.placement)
            state.log_run(name, h, t)
            if done >= h.steps_at_start:
                state.remaining[name] = 0
                continue
            state.gantt.append(GanttEntry(
                name, "restart", 0, t, t + cluster.restart_cost_s,
                kind="restart", device_class=h.device_class))
            state.remaining[name] = max(1, h.steps_at_start - done)
            state.restarting.add(name)
            q.push(RestartDone(t + cluster.restart_cost_s, name))
            restarts += 1
            fleets.evictions += 1

    def _grow_replica(fs, t: float) -> bool:
        g = fs.serve.gpus_per_replica
        dclass = fs.device_class if isinstance(backend, ClassPool) else None
        pl = backend.allocate(g, device_class=dclass)
        if pl is None:
            _fleet_evict(g, fs.device_class, t)
            pl = backend.allocate(g, device_class=dclass)
            if pl is None:
                return False
        next_token[0] += 1
        tok = next_token[0]
        h = LaunchHandle(fs.serve, SERVE_TECH, g, pl, t, 0.0, 0, tok)
        state.note_alloc(tok, t, pl.n_gpus,
                         getattr(pl, "device_class", DEFAULT_CLASS))
        fs.handles.append(h)
        return True

    def _release_replica(fs, t: float) -> None:
        h = fs.handles.pop()
        backend.release(h.placement)
        state.log_run(fs.serve.name, h, t)

    def _measure_step_time(fs) -> float:
        return exec_backend.serve_step_time(fs.serve, fs.device_class)

    class _FleetHooks:
        pass

    hooks = _FleetHooks()
    hooks.grow_replica = _grow_replica
    hooks.release_replica = _release_replica
    hooks.measure_step_time = _measure_step_time
    hooks.profiles = profiles

    def planning_profiles():
        """What replans optimize over: the backend's view (measured
        training step times on real backends), plus the fleet manager's
        measured serve-replica step times when serving is live."""
        base = exec_backend.planning_profiles()
        if fleets is not None and fleets.observed:
            return ObservedProfiles(base, fleets.observed)
        return base

    def allocate_for(entry):
        """Place one entry: class-pinned entries draw from their class's
        pool; class-blind entries on a heterogeneous cluster take the
        first class with room where the config is actually runnable
        (finite estimated step time)."""
        if entry.device_class is None and isinstance(backend, ClassPool) \
                and len(backend.classes) > 1:
            for dc in backend.classes:
                try:
                    st = exec_backend.est_step(entry.job, entry.technique,
                                               entry.n_gpus, dc.name)
                except KeyError:
                    continue  # unprofiled on this class (e.g. count
                    #           exceeds the class's capacity grid)
                if not math.isfinite(st):
                    continue
                pl = backend.allocate(entry.n_gpus, device_class=dc.name)
                if pl is not None:
                    return pl
            return None
        return backend.allocate(entry.n_gpus,
                                preferred_nodes=entry.nodes,
                                device_class=entry.device_class)

    def start_fitting():
        """List scheduling: repeatedly start the first schedule entry
        whose job is admissible and whose GPU request fits."""
        progressed = True
        while progressed:
            progressed = False
            for entry in order.entries:
                name = entry.job
                if name not in state.waiting:
                    continue
                if not backend.feasible(entry.n_gpus,
                                        device_class=entry.device_class):
                    if chaos is not None:
                        # the pool shrank under this entry; capacity may
                        # return (recovery/grant), so wait instead of
                        # declaring the plan unhostable
                        continue
                    raise PlacementError(
                        f"{name}: {entry.n_gpus} GPUs "
                        f"(class {entry.device_class!r}) can never be "
                        f"placed on backend {backend.kind!r}")
                pl = allocate_for(entry)
                if pl is None:
                    continue
                dclass = getattr(pl, "device_class", DEFAULT_CLASS)
                next_token[0] += 1
                tok = next_token[0]
                h = exec_backend.launch(state.by_name[name], entry, pl,
                                        dclass, state.remaining[name],
                                        state.t, tok)
                state.note_alloc(tok, state.t, pl.n_gpus, dclass)
                state.running[name] = h
                launch_tokens[name] = tok
                state.current_assign[name] = entry.assignment
                state.waiting.remove(name)
                q.push(JobCompletion(exec_backend.eta(h), name, tok))
                progressed = True
                break

    def planning_cluster() -> ClusterSpec:
        """What policies plan over.  Without chaos or fleets: the static
        spec, verbatim (legacy paths stay bit-exact).  Under chaos: a
        live view whose per-class capacities track the elastic pools.
        With serving fleets: the fleet-held devices are subtracted too,
        so training replans only target what serving is not using."""
        if chaos is None and fleets is None:
            return cluster
        if isinstance(backend, ClassPool):
            caps = {dc.name: backend.capacity(dc.name)
                    for dc in cluster.device_classes}
            if fleets is not None:
                for name in caps:
                    caps[name] = max(0, caps[name] - fleets.held(name))
            if all(caps[dc.name] == dc.total_gpus
                   for dc in cluster.device_classes):
                return cluster
            dcs = tuple(dataclasses.replace(dc, nodes=1,
                                            gpus_per_node=caps[dc.name])
                        for dc in cluster.device_classes
                        if caps[dc.name] > 0)
            return dataclasses.replace(cluster, device_classes=dcs)
        cap = backend.capacity()
        if fleets is not None:
            cap = max(0, cap - fleets.held())
        if cap == cluster.total_gpus:
            return cluster
        return dataclasses.replace(cluster, nodes=1,
                                   gpus_per_node=max(1, cap),
                                   device_classes=())

    def replan(preempt: bool):
        nonlocal order, replans, restarts
        live = state.live_jobs()
        if not live:
            return
        if fleets is not None and \
                backend.capacity() - fleets.held() <= 0:
            return          # serving holds every device: nothing to plan
        # warm-start-capable policies get the previous schedule, the
        # current time and the running set and may re-solve only the
        # residual; the default delegates to plan() unchanged.  Real
        # backends hand over measured step times where observed.
        order = Schedule.coerce(policy.plan_incremental(
            live, dict(state.remaining), planning_profiles(),
            planning_cluster(), dict(state.current_assign), prev=order,
            now_s=state.t, running=frozenset(state.running)))
        replans += 1
        tel = getattr(order, "telemetry", None)
        if tel is not None:     # which engine planned, at what cost
            solver_log.append({**tel, "t": state.t})
        if preempt:
            new_assign = order.assignment_map()
            for name in list(state.running):
                if name in new_assign and \
                        new_assign[name] != state.current_assign.get(name):
                    h = state.running.pop(name)
                    done = exec_backend.preempt(h, state.t)
                    backend.release(h.placement)
                    state.log_run(name, h, state.t)
                    if done >= h.steps_at_start:
                        # a real worker can finish its whole budget
                        # while the replan solve was running: that is a
                        # completion, not a restart (unreachable in
                        # virtual time — a sim completion event always
                        # fires before its job reaches this branch)
                        state.remaining[name] = 0
                        continue
                    # checkpoint + relaunch penalty: the job is only
                    # admissible again when RestartDone fires
                    state.gantt.append(GanttEntry(
                        name, "restart", 0, state.t,
                        state.t + cluster.restart_cost_s, kind="restart",
                        device_class=h.device_class))
                    state.remaining[name] = max(1, h.steps_at_start - done)
                    state.restarting.add(name)
                    q.push(RestartDone(
                        state.t + cluster.restart_cost_s, name))
                    restarts += 1

    def kill_launches(victims: set, t: float) -> None:
        """Kill every launch touching a victim device, salvaging its
        last periodic checkpoint: progress since
        ``chaos.checkpoint_every_s`` (measured from launch start) is
        lost, progress up to the checkpoint — and everything from before
        this launch — survives.  The job pays the usual restart penalty
        before it is admissible again."""
        nonlocal restarts
        ck = chaos.checkpoint_every_s
        hit = [n for n, h in state.running.items()
               if victims & set(h.placement.devices)]
        for name in hit:
            h = state.running.pop(name)
            done = exec_backend.preempt(h, t)
            t_ck = h.start_s + math.floor(
                max(0.0, t - h.start_s) / ck) * ck
            done = min(done, exec_backend.steps_done(h, t_ck))
            backend.release(h.placement)
            state.log_run(name, h, t)
            if done >= h.steps_at_start:
                state.remaining[name] = 0
                continue
            state.gantt.append(GanttEntry(
                name, "restart", 0, t, t + cluster.restart_cost_s,
                kind="restart", device_class=h.device_class))
            state.remaining[name] = max(1, h.steps_at_start - done)
            state.restarting.add(name)
            q.push(RestartDone(t + cluster.restart_cost_s, name))
            restarts += 1

    def shrink(dclass: str, k: int, t: float, *,
               prefer_free: bool) -> int:
        """Remove up to ``k`` present devices of ``dclass``.  Failures
        (``prefer_free=False``) take the lowest present ids, busy or
        not; revocations/resizes drain the free pool first.  Returns how
        many devices actually left."""
        free = sorted(backend.free_devices(dclass))
        busy = sorted(d for h in state.running.values()
                      for d in h.placement.devices
                      if backend.class_of(d) == dclass)
        pool = (free + busy) if prefer_free else sorted(free + busy)
        victims = set(pool[:k])
        if not victims:
            return 0
        kill_launches(victims, t)
        backend.remove_devices(sorted(victims))
        return len(victims)

    def handle_worker_failure(e: WorkerFailure, t: float) -> bool:
        """Recover one detected worker failure: close the launch at its
        last DURABLE step (the backend's salvage answer — checkpointed
        on disk, loadable at relaunch), then relaunch under exponential
        backoff + jitter, or quarantine the job with a recorded reason
        once the retry budget is exhausted.  The run never deadlocks on
        a failed job and never silently drops one."""
        nonlocal restarts, worker_failures
        h = state.running.get(e.job)
        if h is None or h.token != e.token:
            return False            # stale: that launch is already gone
        worker_failures += 1
        state.running.pop(e.job)
        done = exec_backend.salvage(h)
        backend.release(h.placement)
        state.log_run(e.job, h, t)
        if done >= h.steps_at_start:
            # died AFTER its last step was durably checkpointed: the
            # work survived the worker
            state.remaining[e.job] = 0
            return True
        state.remaining[e.job] = max(1, h.steps_at_start - done)
        fail_counts[e.job] = attempt = fail_counts.get(e.job, 0) + 1
        if attempt > retry.budget:
            state.quarantined[e.job] = (
                f"retry budget exhausted after {attempt} failures; "
                f"last: {e.reason}")
            return True
        delay = max(cluster.restart_cost_s, retry.backoff_s(e.job, attempt))
        state.gantt.append(GanttEntry(
            e.job, "restart", 0, t, t + delay, kind="restart",
            device_class=h.device_class))
        state.restarting.add(e.job)
        q.push(RestartDone(t + delay, e.job))
        restarts += 1
        return True

    def apply_cluster_event(e: ClusterEvent, t: float) -> bool:
        """Mutate the pool for one chaos event; True if anything changed."""
        nonlocal failures
        if isinstance(e, WorkerFailure):
            return handle_worker_failure(e, t)
        if isinstance(e, WorkerFault):
            # injection only: the coordinator must DETECT the damage
            # through its supervision channel (process exit, missed
            # heartbeat, checksum) and synthesize the WorkerFailure —
            # never short-circuited here, so recovery is exercised for
            # real.  No pool change, no replan from this event.
            exec_backend.inject_fault(e, state.running, t)
            return False
        if isinstance(e, NodeFailure):
            removed = shrink(e.device_class, e.n_gpus, t,
                             prefer_free=False)
            if removed:
                failures += 1
                if e.recover_after_s is not None:
                    q.push(NodeRecovery(t + e.recover_after_s, removed,
                                        e.device_class))
            return removed > 0
        if isinstance(e, SpotRevoke):
            # voluntary capacity loss, not a failure: no failure count
            removed = shrink(e.device_class, e.n_gpus, t,
                             prefer_free=True)
            return removed > 0
        if isinstance(e, (NodeRecovery, SpotGrant)):
            backend.add_devices(e.n_gpus, device_class=e.device_class)
            return True
        if isinstance(e, CapacityChange):
            if e.delta > 0:
                backend.add_devices(e.delta, device_class=e.device_class)
                return True
            if e.delta < 0:
                removed = shrink(e.device_class, -e.delta, t,
                                 prefer_free=True)
                return removed > 0
        return False

    def finalize_if_done(t: float) -> bool:
        """When every job's remaining work hits zero, jobs still marked
        running finished at exactly this instant (their own completion
        events are queued at the same time): close their segments and
        release their devices instead of dropping them on the floor."""
        if not state.all_done():
            return False
        for name in list(state.running):
            h = state.running.pop(name)
            exec_backend.complete(h, t)
            backend.release(h.placement)
            state.log_run(name, h, t)
        return True

    if fleets is not None:
        # fleets come up before any training is placed: serving capacity
        # is carved first, the sweep schedules around it
        fleets.resize(hooks, 0.0, introspect_every_s)

    events = 0
    while q:
        if finalize_if_done(state.t) and not (
                fleets is not None and state.t < fleets.horizon_s):
            break
        ev = q.pop()
        events += 1
        if events > max_events:
            raise RuntimeError("execute_runtime: event cap hit")

        if not exec_backend.exact_completions:
            # real clock: sleep until the event's timestamp (interrupted
            # early if a launch finishes), then deliver real completions
            # at their actual finish time before the scheduled event
            exec_backend.wait_until(ev.t)
            finished = exec_backend.drain_finished()
            if finished:
                for h in finished:
                    q.push(JobCompletion(
                        exec_backend.event_time(ev) if h.finish_t is None
                        else h.finish_t, h.job.name, h.token))
                q.push(ev)
                continue

        failed = exec_backend.drain_failures()
        if failed:
            # synthesize detection events and requeue: WorkerFailure is
            # a ClusterEvent (priority above completions), so a failure
            # detected at the instant of a scheduled completion wins the
            # race — the stale completion is then dropped by its token.
            # The failure rides at ev.t, NOT the (possibly later) wall
            # clock: the requeued event keeps its original timestamp,
            # and a failure stamped later would lose to it on pop order
            # (a completion prediction that overran its timestamp would
            # then "complete" the dead worker).  The engine clock still
            # reads event_time() when the failure is processed.
            tf = ev.t
            for h, reason in failed:
                q.push(WorkerFailure(tf, job=h.job.name, token=h.token,
                                     reason=reason))
            q.push(ev)
            continue

        if isinstance(ev, JobArrival):
            state.t = exec_backend.event_time(ev)
            settle(state.t)   # replan must see observed progress
            batch = [ev] + q.pop_while(JobArrival, ev.t)
            for e in batch:
                state.arrived.add(e.job.name)
                state.waiting.append(e.job.name)
            # dynamic policies may preempt running jobs to make room for
            # the new arrival; static ones just extend the plan
            if state.t > 0 and not getattr(policy, "replan_on_arrival", True):
                pass
            else:
                replan(preempt=policy.dynamic and state.t > 0)
            start_fitting()

        elif isinstance(ev, JobCompletion):
            if launch_tokens.get(ev.job) != ev.token or \
                    ev.job not in state.running:
                continue                       # stale (preempted launch)
            h = state.running[ev.job]
            if not exec_backend.exact_completions and \
                    not exec_backend.is_finished(h):
                # the prediction fired early: re-aim at measured progress
                q.push(JobCompletion(exec_backend.eta(h), ev.job, ev.token))
                continue
            state.t = exec_backend.event_time(ev)
            settle(state.t)
            state.running.pop(ev.job)
            exec_backend.complete(h, state.t)
            state.remaining[ev.job] = 0
            backend.release(h.placement)
            state.log_run(ev.job, h, state.t)
            if finalize_if_done(state.t) and not (
                    fleets is not None and state.t < fleets.horizon_s):
                break
            if policy.dynamic and policy.replan_on_completion and \
                    state.waiting:
                replan(preempt=False)
            start_fitting()

        elif isinstance(ev, RestartDone):
            state.t = exec_backend.event_time(ev)
            state.restarting.discard(ev.job)
            state.waiting.append(ev.job)
            start_fitting()

        elif isinstance(ev, ClusterEvent):
            state.t = exec_backend.event_time(ev)
            settle(state.t)   # kills must charge observed progress
            # coalesce a same-instant burst (correlated failures, a
            # grant landing with a revoke) into ONE replan
            batch = [ev] + q.pop_while(ClusterEvent, ev.t)
            changed = False
            for e in batch:
                changed = apply_cluster_event(e, state.t) or changed
            if changed and policy.dynamic and backend.capacity() > 0:
                replan(preempt=True)
            start_fitting()

        elif isinstance(ev, IntrospectionTick):
            serving_live = fleets is not None and ev.t < fleets.horizon_s
            if state.all_done() and not serving_live:
                if fleets is not None:
                    # advance the clock to the traffic horizon so the
                    # final fleet teardown replays the full trace
                    state.t = max(state.t, min(exec_backend.event_time(ev),
                                               fleets.horizon_s))
                continue
            if fleets is not None:
                # rescale fleets to the coming interval's traffic FIRST:
                # growth may evict training launches, and the replan
                # below then plans around the new holdings
                state.t = exec_backend.event_time(ev)
                settle(state.t)
                fleets.plans(planning_profiles())
                fleets.resize(hooks, state.t, introspect_every_s)
            if not (state.running or state.waiting or state.restarting):
                # nothing in the system yet (future arrivals pending):
                # keep the tick chain alive, but there is nothing to
                # settle or replan
                q.push(IntrospectionTick(ev.t + introspect_every_s))
                continue
            state.t = exec_backend.event_time(ev)
            settle(state.t)
            if policy.dynamic:
                replan(preempt=True)
            # chain from the engine clock, not the event's timestamp:
            # on a real backend the tick's work (preempt joins, MILP
            # solves) may overrun ev.t by seconds, and chaining from
            # ev.t would fire a burst of back-to-back catch-up replans.
            # Virtual time has state.t == ev.t, so the sim is unchanged.
            q.push(IntrospectionTick(state.t + introspect_every_s))
            start_fitting()

        # deadlock: nothing running, nothing can ever start it (pending
        # cluster events count — a recovery/grant can restore capacity,
        # and a serving fleet whose traffic will drop can shrink at a
        # future introspection tick)
        if state.waiting and not state.running and not state.restarting \
                and not q.has_any((JobArrival, RestartDone, ClusterEvent)) \
                and not (fleets is not None and fleets.held() > 0
                         and fleets.can_shrink_later(state.t)
                         and q.has_any((IntrospectionTick,))):
            raise RuntimeError(
                f"deadlock: waiting={state.waiting} "
                f"free={backend.free_gpus} order={order.to_tuples()}")

    if not state.all_done():
        unfinished = [n for n, v in state.remaining.items()
                      if v > 0 and n not in state.quarantined]
        raise RuntimeError(f"runtime drained with unfinished jobs: "
                           f"{unfinished}")
    stats = exec_backend.result_stats()
    if fleets is not None:
        fleets.finish(hooks, state.t)
        stats = dict(stats)
        stats["serving"] = fleets.stats()
    if solver_log:
        stats = dict(stats)
        stats["solver"] = solver_log
    verify_conservation(state)
    return SimResult(policy.name, state.t, state.gantt, replans, restarts,
                     failures=failures, stats=stats,
                     worker_failures=worker_failures,
                     quarantined=dict(state.quarantined))


def simulate_runtime(jobs: List[Job], policy: Policy,
                     profiles: Dict[Tuple[str, str, int], Profile],
                     cluster: ClusterSpec, *,
                     introspect_every_s: Optional[float] = None,
                     noise_sigma: float = 0.1, noise_seed: int = 0,
                     max_events: int = 100000,
                     backend: Optional[PlacementBackend] = None,
                     exec_backend: Optional[ExecutionBackend] = None,
                     chaos: Optional[ChaosTrace] = None,
                     fleets=None) -> SimResult:
    """Run ``jobs`` under ``policy`` on the event-driven cluster runtime
    (default execution backend: :class:`SimBackend` in virtual time).
    ``chaos`` injects a :class:`~repro_torch.core.chaos.ChaosTrace` of node
    failures / spot churn / capacity changes; ``fleets`` runs serving
    fleets alongside training (see :func:`execute_runtime`)."""
    exec_backend = exec_backend or SimBackend(noise_sigma=noise_sigma,
                                              noise_seed=noise_seed)
    return execute_runtime(jobs, policy, profiles, cluster,
                           exec_backend=exec_backend,
                           introspect_every_s=introspect_every_s,
                           max_events=max_events, backend=backend,
                           chaos=chaos, fleets=fleets)
