"""Schedule IR — the typed contract between planners and the runtime.

Every policy (baselines and the Saturn MILPs alike) emits a
:class:`Schedule`: an ordered list of :class:`ScheduleEntry` records, one
per job, carrying the chosen parallelism technique, GPU count, the
planner's estimated start/runtime, and (for node-aware planners) a node
hint.  The runtime consumes Schedules; concrete per-device assignments
(:class:`Placement`) are made by a placement backend at launch time and
recorded in the Gantt chart.

Legacy policies that still return ``[(job, technique, n_gpus), ...]``
tuples are accepted everywhere via :meth:`Schedule.coerce`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Placement:
    """A concrete device-set assignment (global GPU indices).

    ``device_class`` records which class pool the devices came from
    (class-aware backends set it; single-class backends leave the
    "default" tag).
    """
    devices: Tuple[int, ...]
    device_class: str = "default"

    @property
    def n_gpus(self) -> int:
        return len(self.devices)

    def nodes(self, gpus_per_node: int) -> Tuple[int, ...]:
        """Node indices this placement touches."""
        return tuple(sorted({d // gpus_per_node for d in self.devices}))


@dataclasses.dataclass(frozen=True)
class ScheduleEntry:
    """One job's planned execution: technique + GPU count, plus optional
    planner estimates (start/runtime) and a node-set hint."""
    job: str
    technique: str
    n_gpus: int
    start_s: Optional[float] = None     # planner-estimated start
    runtime_s: Optional[float] = None   # planner-estimated total runtime
    nodes: Optional[Tuple[int, ...]] = None  # node hint (node-aware MILP)
    device_class: Optional[str] = None  # class pin (class-aware planners);
    #                                     None = any class (class-blind)

    @property
    def assignment(self) -> Tuple:
        """The identity the runtime diffs on replans: preempting when it
        changes.  Class-aware entries include the device class, so a
        replan that migrates a job across classes pays a real restart."""
        if self.device_class is None:
            return (self.technique, self.n_gpus)
        return (self.technique, self.n_gpus, self.device_class)

    @property
    def end_s(self) -> Optional[float]:
        if self.start_s is None or self.runtime_s is None:
            return None
        return self.start_s + self.runtime_s

    def as_tuple(self) -> Tuple[str, str, int]:
        return (self.job, self.technique, self.n_gpus)


@dataclasses.dataclass
class Schedule:
    """An ordered plan over jobs.  Order is the list-scheduling priority:
    the runtime starts the first entry that fits whenever capacity frees
    up."""
    entries: List[ScheduleEntry] = dataclasses.field(default_factory=list)
    solver: str = "policy"              # which planner produced it
    makespan_s: Optional[float] = None  # planner-estimated makespan
    # solver telemetry {backend, wall_s, gap, status, n_jobs} attached by
    # planners that measure their solve; the runtime copies it per
    # (re)plan into SimResult.stats["solver"]
    telemetry: Optional[dict] = None

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def jobs(self) -> List[str]:
        return [e.job for e in self.entries]

    def assignment_map(self) -> Dict[str, Tuple]:
        """job -> (technique, n_gpus[, device_class]); used for
        preemption diffs."""
        return {e.job: e.assignment for e in self.entries}

    def entry_for(self, job: str) -> Optional[ScheduleEntry]:
        for e in self.entries:
            if e.job == job:
                return e
        return None

    def to_tuples(self) -> List[Tuple[str, str, int]]:
        return [e.as_tuple() for e in self.entries]

    @staticmethod
    def from_tuples(tuples: Iterable[Sequence], solver: str = "policy"
                    ) -> "Schedule":
        entries = [ScheduleEntry(str(j), str(tech), int(g))
                   for (j, tech, g) in tuples]
        return Schedule(entries, solver=solver)

    @staticmethod
    def coerce(obj) -> "Schedule":
        """Accept a Schedule, a list of ScheduleEntry, or legacy
        (job, technique, n_gpus) tuples."""
        if isinstance(obj, Schedule):
            return obj
        if obj is None:
            return Schedule([])
        items = list(obj)
        if not items:
            return Schedule([])
        if isinstance(items[0], ScheduleEntry):
            return Schedule(items)
        return Schedule.from_tuples(items)


class Policy:
    """Planner interface: produce a :class:`Schedule` over the live jobs.

    The runtime starts jobs in schedule order whenever GPUs free up
    (list scheduling).  ``plan`` is re-invoked at introspection
    intervals (if ``dynamic``), at job arrivals (if
    ``replan_on_arrival``), and at completion events (if ``dynamic`` and
    ``replan_on_completion``).  Legacy implementations may return
    ``[(job, technique, n_gpus), ...]``; callers coerce.
    """

    name = "policy"
    dynamic = False                # replan (with preemption) at introspection?
    replan_on_completion = True    # also replan when a job finishes?
    replan_on_arrival = True       # also replan when a new job arrives?

    def plan(self, jobs, remaining: Dict[str, int], profiles, cluster,
             current: Dict[str, Tuple[str, int]]) -> "Schedule":
        raise NotImplementedError

    def plan_incremental(self, jobs, remaining: Dict[str, int], profiles,
                         cluster, current: Dict[str, Tuple], *,
                         prev: Optional["Schedule"] = None,
                         now_s: float = 0.0,
                         running=frozenset()) -> "Schedule":
        """Replan hook with warm-start context.

        The runtime calls this (not ``plan``) on every replan, handing
        over the previous :class:`Schedule` (``prev``), the current sim
        time and the set of currently RUNNING job names.  The default
        ignores the context and replans from scratch — exactly the
        historical behavior, so existing policies are untouched.
        Policies that can re-solve incrementally (fix running jobs,
        warm-start from ``prev``) override this.
        """
        return self.plan(jobs, remaining, profiles, cluster, current)
