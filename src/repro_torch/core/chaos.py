"""Fault injection and elasticity: typed cluster events + seeded
generators (ROADMAP item 5).

A :class:`ChaosTrace` is an ordered sequence of concrete
:class:`~repro_torch.core.events.ClusterEvent` subtypes the runtime injects
through its :class:`~repro_torch.core.events.EventQueue`:

- :class:`NodeFailure` — ``n_gpus`` devices of a class die, busy or not
  (lowest present ids).  Launches on dead devices are killed and salvage
  their last periodic checkpoint: progress since
  ``ChaosTrace.checkpoint_every_s`` is lost, NOT the whole launch.  An
  optional ``recover_after_s`` schedules the matching
  :class:`NodeRecovery` automatically.
- :class:`NodeRecovery` / :class:`SpotGrant` — capacity returns / a spot
  grant lands: the placement pool grows by ``n_gpus`` FRESH device ids
  (ids are never reused, so Gantt history and conservation accounting
  stay unambiguous).
- :class:`SpotRevoke` — the provider reclaims ``n_gpus`` spot devices.
  Unlike a failure, revocation is polite: free devices go first, busy
  ones only when the free pool cannot cover the revocation (victims
  still salvage their checkpoints).
- :class:`CapacityChange` — signed administrative resize: ``delta > 0``
  grows the pool, ``delta < 0`` shrinks it (free-first, like a revoke).
- :class:`WorkerFault` — fault INJECTION against a real execution
  backend's workers (SIGKILL mid-step, stalled heartbeats, truncated
  checkpoint files); detection and recovery flow through the normal
  supervision machinery.  :class:`WorkerFailure` is the engine-
  synthesized DETECTION event that routes a dead/hung worker into the
  salvage → backoff (:class:`RetryPolicy`) → relaunch → replan chain.

All events are count-based, not id-based: which concrete devices die is
resolved by the runtime at processing time against the devices actually
present then — so a trace composed of independent generators stays valid
no matter how the pool has grown or shrunk in between.

The generators are seeded and deterministic.  Failure sweeps use Poisson
THINNING: :func:`poisson_node_failures` draws the event stream once at
``max_rate_per_hour`` and keeps each event with probability
``rate / max_rate`` using per-event uniform marks — so the failures at a
higher rate are a strict superset of those at a lower rate (same seed),
which is what makes "Saturn's margin widens with churn" a monotone,
gateable claim rather than seed noise.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Tuple

from .events import ClusterEvent
from .job import DEFAULT_CLASS


@dataclasses.dataclass(frozen=True)
class NodeFailure(ClusterEvent):
    """``n_gpus`` devices of ``device_class`` fail hard (busy included:
    lowest present ids die).  ``recover_after_s`` schedules the matching
    :class:`NodeRecovery` for however many devices actually died."""
    n_gpus: int = 1
    device_class: str = DEFAULT_CLASS
    recover_after_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class NodeRecovery(ClusterEvent):
    n_gpus: int = 1
    device_class: str = DEFAULT_CLASS


@dataclasses.dataclass(frozen=True)
class SpotGrant(ClusterEvent):
    n_gpus: int = 1
    device_class: str = DEFAULT_CLASS


@dataclasses.dataclass(frozen=True)
class SpotRevoke(ClusterEvent):
    """Free devices are reclaimed first; busy ones only if the free pool
    cannot cover the revocation."""
    n_gpus: int = 1
    device_class: str = DEFAULT_CLASS


@dataclasses.dataclass(frozen=True)
class CapacityChange(ClusterEvent):
    """Administrative resize: ``delta > 0`` adds fresh devices,
    ``delta < 0`` removes (free-first)."""
    delta: int = 0
    device_class: str = DEFAULT_CLASS


@dataclasses.dataclass(frozen=True)
class WorkerFault(ClusterEvent):
    """Fault-INJECTION command for fault-capable execution backends
    (the :class:`~repro_torch.core.process_backend.ProcessTorchBackend`): at
    ``t`` the harness really hurts a live worker —

    - ``"sigkill"``: SIGKILL the worker process mid-step (no chance to
      checkpoint; recovery must salvage the last durable checkpoint);
    - ``"hang"``: wedge the worker (it stops heartbeating but stays
      alive; the coordinator must detect the missed heartbeat deadline
      and kill it);
    - ``"corrupt"``: truncate the job's current checkpoint file on disk
      AND SIGKILL the worker (recovery must detect the corruption via
      checksum and fall back to the last-known-good checkpoint).

    ``job`` names the victim; ``None`` picks the first live launch in
    job-name order (deterministic).  Detection and recovery flow through
    the normal supervision machinery — the injection point never
    shortcuts them, so recovery is benchmarked, not assumed.  Unlike the
    other cluster events a WorkerFault does not touch the placement
    pool, so it needs no elastic backend.

    ``min_step`` > 0 defers the strike until the victim's DURABLE
    checkpoint has reached that absolute step: the event still arrives
    at ``t``, but the backend holds it until the next checkpoint-ack at
    or past ``min_step``.  Worker startup cost (process spawn, torch
    import, CUDA context) varies with machine load, so a purely
    wall-clock fault time cannot guarantee a mid-run kill — ``min_step``
    makes "killed after at least one durable checkpoint" a property of
    the trace instead of a race.  A victim that finishes before reaching
    ``min_step`` is never struck.

    ``rank`` picks the process a fault strikes when the victim runs as a
    process group of several ranks (one a device); rank 0 by default.
    """
    kind: str = "sigkill"            # sigkill | hang | corrupt
    job: Optional[str] = None
    min_step: int = 0
    rank: int = 0


@dataclasses.dataclass(frozen=True)
class WorkerFailure(ClusterEvent):
    """A DETECTED worker failure, synthesized by the runtime engine from
    the execution backend's supervision channel (process exit, missed
    heartbeat deadline, escaped worker exception) — not user-authored.
    Riding the cluster-event queue gives failures the same deterministic
    ordering as injected chaos (a failure at the instant of a completion
    wins the race) and routes them into the shared salvage → backoff →
    relaunch → replan machinery.  ``token`` pins the launch so a failure
    of an already-preempted launch is ignored as stale."""
    job: str = ""
    token: int = -1
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Relaunch policy for failed workers: exponential backoff with
    seeded jitter under a bounded per-job retry budget.

    A job's ``attempt``-th failure (1-based) waits
    ``min(cap_s, base_s * 2**(attempt-1))`` scaled by a deterministic
    jitter factor in ``[1-jitter, 1+jitter]`` (seeded per (job,
    attempt), so concurrent victims don't relaunch in lockstep) before
    it is admissible again — never less than the cluster's ordinary
    ``restart_cost_s``.  A job that fails more than ``budget`` times is
    QUARANTINED: taken out of the workload with a recorded reason while
    the rest of the sweep replans onto the surviving capacity; the run
    completes without it instead of deadlocking or crashing."""
    budget: int = 3
    base_s: float = 2.0
    cap_s: float = 60.0
    jitter: float = 0.2
    seed: int = 0

    def __post_init__(self):
        if self.budget < 0:
            raise ValueError("retry budget must be >= 0")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def backoff_s(self, job: str, attempt: int) -> float:
        delay = min(self.cap_s, self.base_s * 2.0 ** max(0, attempt - 1))
        if self.jitter:
            # string seeds hash deterministically (sha512) across
            # processes — no PYTHONHASHSEED dependence
            rng = random.Random(f"{self.seed}:{job}:{attempt}")
            delay *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return delay


@dataclasses.dataclass(frozen=True)
class ChaosTrace:
    """A seeded scenario: cluster events + the checkpoint cadence that
    governs how much progress a killed launch salvages.

    ``checkpoint_every_s`` is the periodic-checkpoint interval measured
    from each launch's start; a launch killed at ``t`` resumes from
    ``start + floor((t - start) / interval) * interval``.  The launch
    start itself always counts as a checkpoint, so a failure never
    erases progress from before the launch."""
    events: Tuple[ClusterEvent, ...] = ()
    checkpoint_every_s: float = 600.0
    name: str = "chaos"

    def __post_init__(self):
        if self.checkpoint_every_s <= 0:
            raise ValueError("checkpoint_every_s must be positive")
        for e in self.events:
            if not isinstance(e, ClusterEvent):
                raise TypeError(f"not a ClusterEvent: {e!r}")
            if e.t < 0:
                raise ValueError(f"event before t=0: {e!r}")
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: e.t)))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)


def poisson_node_failures(rate_per_hour: float, horizon_s: float, *,
                          seed: int = 0,
                          device_class: str = DEFAULT_CLASS,
                          n_gpus: int = 1,
                          recover_after_s: Optional[float] = None,
                          max_rate_per_hour: Optional[float] = None
                          ) -> Tuple[NodeFailure, ...]:
    """Seeded Poisson failure arrivals over ``[0, horizon_s)``.

    With ``max_rate_per_hour`` set, the stream is generated ONCE at the
    max rate and thinned: an event survives iff its uniform mark is
    below ``rate / max_rate``.  Sweeping ``rate_per_hour`` under a fixed
    ``max_rate_per_hour`` and seed therefore yields nested traces —
    every failure at rate r also occurs at every rate r' > r.
    """
    if rate_per_hour < 0:
        raise ValueError("rate_per_hour must be >= 0")
    max_rate = max_rate_per_hour if max_rate_per_hour is not None \
        else rate_per_hour
    if rate_per_hour > max_rate:
        raise ValueError(f"rate_per_hour {rate_per_hour} exceeds "
                         f"max_rate_per_hour {max_rate}")
    if max_rate <= 0:
        return ()
    rng = random.Random(seed)
    lam = max_rate / 3600.0
    out: List[NodeFailure] = []
    t = 0.0
    while True:
        # draw the gap AND the thinning mark unconditionally so the
        # underlying stream is identical across rates (superset property)
        t += rng.expovariate(lam)
        keep = rng.random() * max_rate < rate_per_hour
        if t >= horizon_s:
            break
        if keep:
            out.append(NodeFailure(t, n_gpus, device_class,
                                   recover_after_s))
    return tuple(out)


def poisson_worker_faults(rate_per_hour: float, horizon_s: float, *,
                          seed: int = 0,
                          kinds: Sequence[str] = ("sigkill", "hang",
                                                  "corrupt"),
                          jobs: Optional[Sequence[str]] = None
                          ) -> Tuple[WorkerFault, ...]:
    """Seeded Poisson worker-fault arrivals over ``[0, horizon_s)``:
    each event draws its kind uniformly from ``kinds`` and its victim
    from ``jobs`` (``None``: let the backend pick the first live
    launch).  The fault-injection counterpart of
    :func:`poisson_node_failures` — same seed, same times, every run."""
    if rate_per_hour < 0:
        raise ValueError("rate_per_hour must be >= 0")
    if not kinds:
        raise ValueError("kinds must be non-empty")
    if rate_per_hour == 0:
        return ()
    rng = random.Random(seed)
    lam = rate_per_hour / 3600.0
    out: List[WorkerFault] = []
    t = 0.0
    while True:
        t += rng.expovariate(lam)
        if t >= horizon_s:
            break
        kind = kinds[rng.randrange(len(kinds))]
        job = jobs[rng.randrange(len(jobs))] if jobs else None
        out.append(WorkerFault(t, kind, job))
    return tuple(out)


def spot_capacity_trace(horizon_s: float, *, seed: int = 0,
                        device_class: str = DEFAULT_CLASS,
                        n_gpus: int = 1,
                        mean_up_s: float = 1800.0,
                        mean_down_s: float = 900.0
                        ) -> Tuple[ClusterEvent, ...]:
    """Two-state spot availability: the capacity starts granted, is
    revoked after an Exp(mean_up_s) hold, re-granted after an
    Exp(mean_down_s) outage, and so on — the classic price-spike
    availability trace, alternating :class:`SpotRevoke` /
    :class:`SpotGrant` events over ``n_gpus`` devices."""
    if mean_up_s <= 0 or mean_down_s <= 0:
        raise ValueError("mean_up_s and mean_down_s must be positive")
    rng = random.Random(seed)
    out: List[ClusterEvent] = []
    t, available = 0.0, True
    while True:
        t += rng.expovariate(1.0 / (mean_up_s if available
                                    else mean_down_s))
        if t >= horizon_s:
            break
        out.append(SpotRevoke(t, n_gpus, device_class) if available
                   else SpotGrant(t, n_gpus, device_class))
        available = not available
    return tuple(out)


def merge_events(*seqs: Sequence[ClusterEvent]
                 ) -> Tuple[ClusterEvent, ...]:
    """Merge independently generated event streams into one time-sorted
    tuple (e.g. a failure trace + a spot trace over different classes)."""
    out: List[ClusterEvent] = []
    for s in seqs:
        out.extend(s)
    return tuple(sorted(out, key=lambda e: e.t))
