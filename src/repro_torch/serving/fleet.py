"""SLO-aware fleet planning + the runtime's serving-fleet manager.

This is the planning/execution layer between :class:`~repro_torch.core.job.ServeJob`
(a model + latency SLO + traffic trace) and the
:class:`~repro_torch.serving.engine.ContinuousBatchingEngine` replicas that
serve it:

- :func:`serve_profiles` turns a cluster's device classes into per-class
  serve profiles (per-token engine step time of one replica), the same
  ``(name, technique, class, count)`` key shape training profiles use —
  so serve throughput rides the existing profile plumbing
  (:class:`~repro_torch.core.perfmodel.ObservedProfiles` overlays, noise
  factors, solver adapters) unchanged.
- :func:`plan_fleets` picks, per fleet, a device class and a per-window
  replica count from those curves under the p99-latency SLO — the
  serving half of the joint plan.  :func:`fleet_reservations` converts a
  plan into the solver's ``(class, gpus, release_s)`` capacity
  reservations so the training MILP optimizes around it.
- :func:`simulate_fleet` is the queueing model the virtual-time backend
  scores traces with: each replica contributes ``slots`` deterministic
  servers (a request occupies one slot for ``tokens_per_request`` engine
  steps), server count follows the fleet's resize history.
- :class:`FleetManager` drives fleets inside the event runtime:
  allocates replica device blocks from the placement pool (so GPU-second
  conservation covers serving), rescales them at introspection ticks as
  traffic shifts, records measured step times for the
  ``ObservedProfiles`` feedback loop, and computes the per-window
  p50/p99/attainment stats that land in ``SimResult.stats``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.job import SERVE_TECH, ClusterSpec, ServeJob
from ..core.perfmodel import profile_key, step_time_of
from ..core.profiler import Profile
from ..data.traffic import window_rates

# a replica's deterministic service time must leave this fraction of the
# SLO as queueing headroom for the class to be considered feasible
SERVICE_SLO_FRAC = 0.6
# target utilization the replica count is sized to (capacity headroom
# absorbs within-window burstiness so the p99 stays inside the SLO)
DEFAULT_UTIL_CAP = 0.7


def serve_profiles(serves: Sequence[ServeJob], cluster: ClusterSpec, *,
                   base_step_s: float = 0.02,
                   ref_d_model: int = 512) -> Dict[Tuple, Profile]:
    """Analytic per-class serve profiles: one :class:`Profile` per
    (fleet, device class) keyed ``(name, SERVE_TECH, class,
    gpus_per_replica)`` whose ``step_time_s`` is the per-token engine
    step time of a single replica.

    Decode is memory-bound, so the step time scales with model width
    and inversely with the class's ``speed_hint`` — the same shape the
    roofline profiler uses for training steps.  Callers with measured
    engines overwrite these through ``ObservedProfiles``.
    """
    out: Dict[Tuple, Profile] = {}
    for s in serves:
        width = getattr(s.cfg, "d_model", ref_d_model) or ref_d_model
        for dc in cluster.device_classes:
            st = base_step_s * (width / ref_d_model) / max(dc.speed_hint,
                                                           1e-9)
            out[(s.name, SERVE_TECH, dc.name, s.gpus_per_replica)] = \
                Profile(s.name, SERVE_TECH, s.gpus_per_replica, st,
                        mem_per_device=0.0, feasible=True,
                        source="analytic-serve", device_class=dc.name)
    return out


def required_replicas(serve: ServeJob, step_time_s: float, rate_rps: float,
                      *, util_cap: float = DEFAULT_UTIL_CAP) -> int:
    """Smallest replica count whose slot capacity covers ``rate_rps``
    with ``util_cap`` headroom.  A replica serves ``slots`` concurrent
    requests, each holding a slot for ``tokens_per_request *
    step_time_s`` seconds."""
    service_s = serve.tokens_per_request * step_time_s
    per_replica = serve.slots / service_s          # req/s at 100% util
    if rate_rps <= 0:
        return 1
    return max(1, int(math.ceil(rate_rps / (util_cap * per_replica))))


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """The solver-facing serving plan for one fleet: the chosen device
    class and the replica count per traffic window."""
    serve: ServeJob
    device_class: str
    step_time_s: float               # per-token step estimate used
    window_s: float
    replicas: Tuple[int, ...]        # per window

    @property
    def peak_replicas(self) -> int:
        return max(self.replicas) if self.replicas else 1

    def gpus(self, window: int) -> int:
        w = min(max(window, 0), len(self.replicas) - 1)
        return self.replicas[w] * self.serve.gpus_per_replica

    @property
    def peak_gpus(self) -> int:
        return self.peak_replicas * self.serve.gpus_per_replica


def plan_fleet(serve: ServeJob, profiles, cluster: ClusterSpec, *,
               window_s: float, horizon_s: float,
               util_cap: float = DEFAULT_UTIL_CAP,
               device_class: Optional[str] = None) -> FleetPlan:
    """Pick a device class + per-window replica counts for one fleet.

    A class is feasible when its deterministic service time fits inside
    ``SERVICE_SLO_FRAC`` of the SLO (queueing needs the rest) and its
    peak replica demand fits the class's capacity.  Among feasible
    classes the one spending the fewest GPU-seconds wins; ties go to the
    slowest class (lowest ``speed_hint``) so fast GPUs stay available
    for training."""
    rates = window_rates(serve.trace, window_s, horizon_s)
    candidates = []
    for dc in cluster.device_classes:
        if device_class is not None and dc.name != device_class:
            continue                   # fleet already pinned to a class
        try:
            st = step_time_of(profiles, serve.name, SERVE_TECH,
                              serve.gpus_per_replica, device_class=dc.name)
        except KeyError:
            continue
        if not math.isfinite(st):
            continue
        service_s = serve.tokens_per_request * st
        if service_s > SERVICE_SLO_FRAC * serve.slo_p99_s:
            continue                       # class too slow for the SLO
        reps = tuple(min(serve.max_replicas,
                         required_replicas(serve, st, r,
                                           util_cap=util_cap))
                     for r in rates)
        if max(reps) * serve.gpus_per_replica > dc.total_gpus:
            continue                       # peak does not fit the class
        gpu_s = sum(reps) * serve.gpus_per_replica * window_s
        candidates.append((gpu_s, dc.speed_hint, dc.name, st, reps))
    if not candidates:
        raise ValueError(
            f"fleet {serve.name}: no device class meets the "
            f"{serve.slo_p99_s:g}s p99 SLO within capacity")
    gpu_s, _, name, st, reps = min(candidates)
    return FleetPlan(serve, name, st, window_s, reps)


def plan_fleets(serves: Sequence[ServeJob], profiles,
                cluster: ClusterSpec, *, window_s: float,
                horizon_s: float,
                util_cap: float = DEFAULT_UTIL_CAP
                ) -> Dict[str, FleetPlan]:
    return {s.name: plan_fleet(s, profiles, cluster, window_s=window_s,
                               horizon_s=horizon_s, util_cap=util_cap)
            for s in serves}


def fleet_reservations(plans: Dict[str, FleetPlan]
                       ) -> List[Tuple[Optional[str], int, float]]:
    """Convert fleet plans into the solver's ``(class, gpus,
    release_s)`` reservation triples.

    Reservations hold from t=0 until release, so the tightest expressible
    envelope of a time-varying demand is its non-increasing majorant:
    ``env(w) = max demand over windows >= w``.  Growth later in the
    horizon is therefore pre-reserved (conservative for the SLO; the
    runtime's replans reclaim the slack as windows pass)."""
    out: List[Tuple[Optional[str], int, float]] = []
    for plan in plans.values():
        demand = [plan.gpus(w) for w in range(len(plan.replicas))]
        if not demand:
            continue
        env = list(demand)
        for w in range(len(env) - 2, -1, -1):
            env[w] = max(env[w], env[w + 1])
        # decompose the non-increasing envelope into hold-until triples
        out.append((plan.device_class, env[-1], math.inf))
        for w in range(len(env) - 1):
            drop = env[w] - env[w + 1]
            if drop > 0:
                out.append((plan.device_class, drop,
                            (w + 1) * plan.window_s))
    return out


def simulate_fleet(arrivals: Sequence[float], service_s: float,
                   servers: Sequence[Tuple[float, int]]) -> List[float]:
    """FIFO multi-server queueing sim: request latencies under a
    time-varying server count.

    ``servers`` is the fleet's resize history ``[(t, n_servers), ...]``
    (each entry: total concurrent slots from ``t`` on).  Service is
    deterministic (``service_s`` per request).  Shrinks drop the most
    backlogged servers — in-flight latencies already assigned stand, the
    survivors carry the queue.  A request that can never be served
    (no servers for the rest of time) gets ``inf``."""
    if service_s <= 0:
        raise ValueError("service_s must be > 0")
    changes = sorted(servers)
    free: List[float] = []               # next-free time per live server
    cur, ci = 0, 0
    lat: List[float] = []

    def resize(n: int, t: float) -> None:
        nonlocal cur
        if n > cur:
            for _ in range(n - cur):
                heapq.heappush(free, t)
        elif n < cur:
            keep = sorted(free)[:n]
            free[:] = keep
            heapq.heapify(free)
        cur = n

    for a in sorted(arrivals):
        while ci < len(changes) and changes[ci][0] <= a:
            resize(changes[ci][1], changes[ci][0])
            ci += 1
        if not free:
            # no capacity now: the request waits for the next grow
            j = ci
            while j < len(changes) and changes[j][1] <= 0:
                j += 1
            if j == len(changes):
                lat.append(math.inf)
                continue
            while ci <= j:
                resize(changes[ci][1], changes[ci][0])
                ci += 1
        start = max(a, heapq.heappop(free))
        heapq.heappush(free, start + service_s)
        lat.append(start - a + service_s)
    return lat


def window_stats(arrivals: Sequence[float], latencies: Sequence[float],
                 slo_s: float, window_s: float, horizon_s: float) -> dict:
    """Per-window p50/p99 latency + SLO attainment, and the overall
    attainment across every request (the bench's gate)."""
    n = max(1, int(math.ceil(horizon_s / window_s)))
    buckets: List[List[float]] = [[] for _ in range(n)]
    for a, l in zip(sorted(arrivals), latencies):
        if 0.0 <= a < horizon_s:
            buckets[min(n - 1, int(a // window_s))].append(l)
    windows = []
    for w, bucket in enumerate(buckets):
        if not bucket:
            windows.append({"t_s": w * window_s, "requests": 0})
            continue
        arr = np.asarray(bucket)
        windows.append({
            "t_s": w * window_s,
            "requests": len(bucket),
            # "lower" avoids inf-inf interpolation when a request never
            # found a server (fleet scaled to zero under live traffic)
            "p50_s": float(np.percentile(arr, 50, method="lower")),
            "p99_s": float(np.percentile(arr, 99, method="lower")),
            "attainment": float(np.mean(arr <= slo_s)),
        })
    served = [l for b in buckets for l in b]
    overall = float(np.mean(np.asarray(served) <= slo_s)) \
        if served else 1.0
    return {"slo_p99_s": slo_s, "requests": len(served),
            "attainment": overall, "windows": windows}


class _FleetState:
    """Runtime state of one live fleet: its replica allocations and the
    (time, total-slots) resize history the queueing sim replays."""

    def __init__(self, serve: ServeJob, device_class: str):
        self.serve = serve
        self.device_class = device_class
        self.handles: List = []          # live per-replica LaunchHandles
        self.history: List[Tuple[float, int]] = []   # (t, total slots)
        self.step_time_s: float = float("nan")       # measured per-token

    @property
    def replicas(self) -> int:
        return len(self.handles)

    def log_size(self, t: float) -> None:
        self.history.append((t, self.replicas * self.serve.slots))


class FleetManager:
    """Drives serving fleets inside :func:`~repro_torch.core.runtime.
    execute_runtime`.

    ``adaptive=True`` (Saturn) rescales each fleet at every introspection
    tick to the demand of the windows the coming interval covers;
    ``adaptive=False`` is the static-partition practice: peak-provision
    once at t=0 and never touch it again.  Either way replicas are real
    placement-pool allocations with Gantt segments and GPU-second
    accounting, and measured step times feed the ``observed`` overlay
    replans plan over."""

    def __init__(self, serves: Sequence[ServeJob], cluster: ClusterSpec,
                 *, window_s: float, horizon_s: Optional[float] = None,
                 util_cap: float = DEFAULT_UTIL_CAP,
                 adaptive: bool = True):
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        self.serves = list(serves)
        self.cluster = cluster
        self.window_s = float(window_s)
        self.horizon_s = float(horizon_s) if horizon_s is not None else \
            max([max(s.trace) if s.trace else 0.0
                 for s in self.serves] + [window_s])
        self.util_cap = util_cap
        self.adaptive = adaptive
        self.observed: Dict[Tuple, float] = {}
        self._fleets: Dict[str, _FleetState] = {}
        self._plans: Dict[str, FleetPlan] = {}
        self._stats: Dict[str, dict] = {}
        self.evictions = 0               # training launches evicted

    # ------------------------------------------------------------ sizing
    def plans(self, profiles) -> Dict[str, FleetPlan]:
        """(Re)plan every fleet's class + per-window replicas from the
        current profile view — estimates at first, measured step times
        once the fleets run (the ObservedProfiles feedback loop).  A
        fleet that is already live stays pinned to its class; if the
        observed curve makes the pinned class infeasible the previous
        plan is kept (the SLO stats will show the miss honestly)."""
        for s in self.serves:
            fs = self._fleets.get(s.name)
            pin = fs.device_class if fs is not None else None
            try:
                self._plans[s.name] = plan_fleet(
                    s, profiles, self.cluster, window_s=self.window_s,
                    horizon_s=self.horizon_s, util_cap=self.util_cap,
                    device_class=pin)
            except ValueError:
                if s.name not in self._plans:
                    raise
        return self._plans

    def target_replicas(self, name: str, t: float,
                        lookahead_s: float) -> int:
        """Replica target at time ``t``: the max windowed demand over
        ``[t, t + lookahead_s)`` (adaptive) or the all-horizon peak
        (static)."""
        plan = self._plans[name]
        if not self.adaptive:
            return plan.peak_replicas
        if t >= self.horizon_s:
            return 0                     # trace exhausted: stand down
        w0 = int(t // self.window_s)
        w1 = int(math.ceil((t + max(lookahead_s, self.window_s))
                           / self.window_s))
        return max(plan.replicas[min(w, len(plan.replicas) - 1)]
                   for w in range(w0, max(w1, w0 + 1)))

    def held(self, device_class: Optional[str] = None) -> int:
        total = 0
        for fs in self._fleets.values():
            if device_class is None or fs.device_class == device_class:
                total += sum(h.n_gpus for h in fs.handles)
        return total

    def can_shrink_later(self, t: float) -> bool:
        """Whether any fleet's future target is below its current size —
        the runtime's deadlock check waits on this."""
        if not self.adaptive:
            return False
        for name, fs in self._fleets.items():
            future = [self.target_replicas(name, tt, self.window_s)
                      for tt in np.arange(t, self.horizon_s + self.window_s,
                                          self.window_s)] + [0]
            if min(future) < fs.replicas:
                return True
        return False

    # ---------------------------------------------------------- runtime
    def resize(self, runtime, t: float, lookahead_s: float) -> bool:
        """Bring every fleet to its target for the coming interval.
        ``runtime`` is the engine's :class:`FleetRuntimeHooks` bridge
        (allocate/release/evict + step-time measurement).  Returns True
        when any fleet changed size (the policy should replan)."""
        any_changed = False
        for serve in self.serves:
            name = serve.name
            plan = self._plans[name]
            fs = self._fleets.get(name)
            if fs is None:
                fs = self._fleets[name] = _FleetState(serve,
                                                      plan.device_class)
                if t > 0:
                    fs.log_size(0.0)     # no capacity before it came up
            target = self.target_replicas(name, t, lookahead_s)
            changed = False
            while fs.replicas > target:
                runtime.release_replica(fs, t)
                changed = True
            while fs.replicas < target:
                if not runtime.grow_replica(fs, t):
                    break                # truly no capacity: retry next tick
                changed = True
            if changed or not fs.history:
                fs.log_size(t)
            if fs.handles and name not in self.observed_keys():
                st = runtime.measure_step_time(fs)
                fs.step_time_s = st
                key = profile_key(runtime.profiles, name, SERVE_TECH,
                                  serve.gpus_per_replica, fs.device_class)
                self.observed[key] = st
            any_changed = any_changed or changed
        return any_changed

    def observed_keys(self):
        return {k[0] for k in self.observed}

    def finish(self, runtime, t: float) -> None:
        """Release every fleet and score the full run: replay each trace
        through the queueing sim against the fleet's resize history."""
        for name, fs in self._fleets.items():
            while fs.handles:
                runtime.release_replica(fs, t)
            fs.log_size(t)
            serve = fs.serve
            st = fs.step_time_s
            if not math.isfinite(st):
                st = self._plans[name].step_time_s
            service_s = serve.tokens_per_request * st
            horizon = min(self.horizon_s, max(t, self.window_s))
            arrivals = [a for a in serve.trace if a < horizon]
            lat = simulate_fleet(arrivals, service_s, fs.history)
            stats = window_stats(arrivals, lat, serve.slo_p99_s,
                                 self.window_s, horizon)
            stats["device_class"] = fs.device_class
            stats["step_time_s"] = st
            stats["peak_replicas"] = max(
                (n // serve.slots for _, n in fs.history), default=0)
            stats["history"] = list(fs.history)
            self._stats[name] = stats

    def stats(self) -> Dict[str, dict]:
        out = dict(self._stats)
        out["evictions"] = self.evictions
        return out
