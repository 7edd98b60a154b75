"""Event types + queue for the cluster runtime.

The runtime is a discrete-event simulation over five event families:

- :class:`JobArrival` — a job enters the system (online workloads carry
  ``Job.arrival_s``; offline workloads all arrive at t=0).
- :class:`ClusterEvent` — the cluster itself changes: node failures,
  spot grants/revocations, capacity grow/shrink.  Concrete types live
  in :mod:`repro_torch.core.chaos`; only the base class (and its priority
  slot) is defined here so the queue's total order is in one place.
- :class:`JobCompletion` — a running job finishes its remaining steps.
  Carries a launch token so completions of preempted launches are
  ignored as stale.
- :class:`RestartDone` — a preempted job finished its checkpoint +
  relaunch penalty and is admissible again.  This is what makes the
  restart cost *real*: the job cannot re-occupy GPUs before this fires.
- :class:`IntrospectionTick` — the paper's introspection interval:
  settle observed progress and (for dynamic policies) re-solve.

Tie-breaking at equal timestamps follows the legacy simulator:
arrivals first, then cluster events, then completions, then restart
wake-ups, then introspection; among equals, FIFO by push order.
A :class:`~repro_torch.core.chaos.NodeFailure` at the same instant as a
:class:`JobCompletion` therefore deterministically processes FIRST — a
job whose devices die at the very moment it would have finished loses
the race (conservative, and pinned by tests/test_events.py).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class Event:
    t: float
    PRIORITY = 99


@dataclasses.dataclass(frozen=True)
class JobArrival(Event):
    PRIORITY = 0
    job: object = None            # core.job.Job


@dataclasses.dataclass(frozen=True)
class ClusterEvent(Event):
    """Base for cluster-topology events (failures, spot churn, capacity
    changes).  Processes after same-instant arrivals but BEFORE
    same-instant completions; see module docstring."""
    PRIORITY = 1


@dataclasses.dataclass(frozen=True)
class JobCompletion(Event):
    PRIORITY = 2
    job: str = ""
    token: int = -1               # launch token; stale if it mismatches


@dataclasses.dataclass(frozen=True)
class RestartDone(Event):
    PRIORITY = 3
    job: str = ""


@dataclasses.dataclass(frozen=True)
class IntrospectionTick(Event):
    PRIORITY = 4


class EventQueue:
    """Min-heap over (t, priority, seq); seq keeps FIFO order stable."""

    def __init__(self):
        self._heap = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def push(self, ev: Event) -> None:
        heapq.heappush(self._heap, (ev.t, ev.PRIORITY, self._seq, ev))
        self._seq += 1

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[3]

    def peek(self) -> Optional[Event]:
        return self._heap[0][3] if self._heap else None

    def pop_while(self, kind: Type[Event], t: float, eps: float = 1e-12):
        """Pop and yield consecutive events of ``kind`` at time ~t (used
        to coalesce same-instant arrival batches into one replan)."""
        out = []
        while self._heap:
            nxt = self._heap[0][3]
            if isinstance(nxt, kind) and abs(nxt.t - t) <= eps:
                out.append(heapq.heappop(self._heap)[3])
            else:
                break
        return out

    def has_any(self, kinds: Tuple[Type[Event], ...]) -> bool:
        return any(isinstance(item[3], kinds) for item in self._heap)
