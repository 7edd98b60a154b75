"""Interval-time Large-Neighborhood-Search scheduler (ROADMAP item 3).

The time-indexed MILP discretizes time into slots, so its binary count
— and therefore its wall time — scales with ``n_jobs * n_choices *
n_slots``; BENCH_solver shows it pinned at the wall cap from 32 jobs
up.  This module is the portfolio's second engine: it plans over an
*interval-time* representation — every job has a real-valued start and
one chosen ``Choice``; no slot grid, no discretization error — and
searches by Large-Neighborhood Search:

1. seed with the objective-aware reservation-aware greedy incumbent
   (:func:`~repro_torch.core.solver.greedy_schedule`), or a caller-provided
   previous plan when replanning incrementally;
2. each iteration DESTROYS a neighborhood (random job subset /
   worst-contributing jobs under the active objective / a time window
   around the makespan critical path / one device-class's jobs) and
   REPAIRS it by earliest-fit reinsertion against per-class
   free-capacity step functions;
3. candidates are accepted by a simulated-annealing schedule, and the
   best-so-far plan is returned at the deadline — so the search is
   *anytime*: more budget, better plan, never worse than its seed.

Per-class capacity is enforced by event sweep: occupancy deltas at
start/end times, prefix-summed into a free-capacity step function per
budget pool.  ``reserved=`` triples ``(class_or_None, gpus,
release_s)`` pre-load the sweep exactly as the MILP's capacity rows do,
so serving fleets and kept-running jobs co-exist.  All four
``OBJECTIVES`` are supported; candidate plans are scored through the
vectorized :func:`~repro_torch.core.solver.objective_values_batch` (per-job
completion arrays — no per-job Python loops in the hot path).

Determinism: the search is driven by one seeded RNG and the deadline is
only consulted *between* iterations, so two runs with the same seed
whose iteration budget (``max_iters``) binds before the wall deadline
produce bit-identical plans.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .job import Job
from .solver import (Assignment, Choice, Solution, _pool_of, _rank_jobs,
                     OBJECTIVES, greedy_schedule, objective_arrays,
                     objective_values_batch)

_EPS = 1e-9


def validate_capacity(assignments: Iterable[Assignment],
                      budgets: Dict[Optional[str], int],
                      reserved: Iterable[Tuple] = (),
                      tol: float = 1e-6) -> bool:
    """Event-sweep conservation check: per budget pool, the running
    GPU occupancy (assignments + ``reserved`` triples) never exceeds the
    pool's capacity.  The plan-level twin of the runtime's
    ``verify_conservation`` — used on solver output, before execution.
    """
    events: Dict[Optional[str], List[Tuple[float, float]]] = \
        {p: [] for p in budgets}
    for dc, g, release_s in reserved:
        p = dc if dc in budgets else None
        events[p].append((0.0, float(g)))
        if math.isfinite(release_s):
            events[p].append((float(release_s), -float(g)))
    for a in assignments:
        p = a.device_class if a.device_class in budgets else None
        events[p].append((a.start_s, float(a.n_gpus)))
        events[p].append((a.end_s, -float(a.n_gpus)))
    for p, evs in events.items():
        if not evs:
            continue
        ev = np.asarray(evs)
        t, d = ev[:, 0], ev[:, 1]
        ut, inv = np.unique(t, return_inverse=True)
        delta = np.zeros(ut.size)
        np.add.at(delta, inv, d)   # same-instant end+start nets out
        if np.cumsum(delta).max() > budgets[p] + tol:
            return False
    return True


class _Timeline:
    """Per-pool free-capacity step functions under construction.

    Holds occupancy events (reservations + already-placed jobs) and
    answers "earliest feasible start for g GPUs over rt seconds" with
    one vectorized pass: free capacity per segment via prefix sum, then
    for each candidate segment the next too-full segment via
    searchsorted — O(E) per query after an O(E log E) rebuild, rebuilt
    lazily only for pools that changed.
    """

    def __init__(self, budgets: Dict[Optional[str], int],
                 reserved: Iterable[Tuple] = ()):
        self.cap = {p: float(g) for p, g in budgets.items()}
        self._ev: Dict[Optional[str], List[Tuple[float, float]]] = \
            {p: [] for p in budgets}
        for dc, g, release_s in reserved:
            p = dc if dc in budgets else None
            self._ev[p].append((0.0, -float(g)))
            if math.isfinite(release_s):
                self._ev[p].append((float(release_s), float(g)))
        self._cache: Dict[Optional[str], Tuple[np.ndarray, np.ndarray]] = {}

    def add(self, pool: Optional[str], t0: float, t1: float,
            g: int) -> None:
        self._ev[pool].append((t0, -float(g)))
        self._ev[pool].append((t1, float(g)))
        self._cache.pop(pool, None)

    def _arrays(self, pool) -> Tuple[np.ndarray, np.ndarray]:
        """(times, free): free[i] GPUs available on [times[i],
        times[i+1]) (last segment extends to +inf); times[0] == 0."""
        got = self._cache.get(pool)
        if got is not None:
            return got
        evs = self._ev[pool]
        if not evs:
            out = (np.zeros(1), np.array([self.cap[pool]]))
            self._cache[pool] = out
            return out
        ev = np.asarray(evs)
        ut, inv = np.unique(ev[:, 0], return_inverse=True)
        delta = np.zeros(ut.size)
        np.add.at(delta, inv, ev[:, 1])
        free = self.cap[pool] + np.cumsum(delta)
        if ut[0] > 0.0:
            ut = np.concatenate([[0.0], ut])
            free = np.concatenate([[self.cap[pool]], free])
        out = (ut, free)
        self._cache[pool] = out
        return out

    def earliest_start(self, pool: Optional[str], g: int,
                       rt: float) -> Optional[float]:
        """Earliest t >= 0 with >= g GPUs free throughout [t, t+rt), or
        None when the pool can never host g GPUs (standing reservations
        eat the capacity forever)."""
        times, free = self._arrays(pool)
        ok_seg = free >= g - _EPS
        bad = np.flatnonzero(~ok_seg)
        if bad.size == 0:
            return 0.0
        # next too-full segment at or after each segment i; feasible
        # starts need that segment to begin at or after t_i + rt
        nxt_i = np.searchsorted(bad, np.arange(times.size))
        nxt_t = np.where(nxt_i < bad.size,
                         times[bad[np.minimum(nxt_i, bad.size - 1)]],
                         np.inf)
        ok = ok_seg & (nxt_t >= times + rt - _EPS)
        if not ok.any():
            return None
        return float(times[int(np.argmax(ok))])


class _Plan:
    """One interval-time plan: per-job choice index + real start."""

    __slots__ = ("ci", "start")

    def __init__(self, ci: np.ndarray, start: np.ndarray):
        self.ci = ci
        self.start = start

    def copy(self) -> "_Plan":
        return _Plan(self.ci.copy(), self.start.copy())


class LnsState:
    """Problem instance + precomputed per-job arrays shared across the
    search (choice attributes, objective arrays, greedy insertion
    rank)."""

    def __init__(self, jobs: List[Job],
                 choice_map: Dict[str, List[Choice]],
                 budgets: Dict[Optional[str], int],
                 reserved: Iterable[Tuple] = (),
                 objective: str = "makespan"):
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"expected one of {OBJECTIVES}")
        self.jobs = jobs
        self.choice_map = choice_map
        self.budgets = dict(budgets)
        self.reserved = list(reserved)
        self.objective = objective
        self.n = len(jobs)
        # flat per-(job, choice) attributes
        self.ch_g = [np.array([c.n_gpus for c in choice_map[j.name]])
                     for j in jobs]
        self.ch_rt = [np.array([c.runtime_s for c in choice_map[j.name]])
                      for j in jobs]
        self.ch_pool = [[_pool_of(c, self.budgets)
                         for c in choice_map[j.name]] for j in jobs]
        self.arrays = objective_arrays(jobs)
        self._cap_total = float(max(sum(self.budgets.values()), 1))
        order = _rank_jobs(jobs, choice_map, objective)
        pos = {j.name: i for i, j in enumerate(jobs)}
        self.rank = np.array([pos[j.name] for j in order])  # insert order
        self.deadline_arr = self.arrays["deadline"]
        self.weight_arr = self.arrays["weight"]

    def ends(self, plan: _Plan) -> np.ndarray:
        rt = np.array([self.ch_rt[i][plan.ci[i]] for i in range(self.n)])
        return plan.start + rt

    def value(self, plan: _Plan) -> float:
        return objective_values_batch(self.ends(plan),
                                      objective=self.objective,
                                      arrays=self.arrays)

    def timeline_of(self, plan: _Plan,
                    skip: Optional[np.ndarray] = None) -> _Timeline:
        """Occupancy timeline of ``plan`` minus the ``skip`` job mask."""
        tl = _Timeline(self.budgets, self.reserved)
        for i in range(self.n):
            if skip is not None and skip[i]:
                continue
            ci = plan.ci[i]
            tl.add(self.ch_pool[i][ci], plan.start[i],
                   plan.start[i] + self.ch_rt[i][ci],
                   int(self.ch_g[i][ci]))
        return tl

    def insert(self, tl: _Timeline, i: int, beta: float = 0.0,
               target: Optional[float] = None) -> Tuple[int, float]:
        """Insertion of job i, committed to the timeline.

        Default rule: over the job's choices, pick the (choice,
        earliest feasible start) minimizing ``end + beta * gpu_area /
        total_capacity`` (ties: fewer GPUs).  ``beta`` trades completion
        time against GPU-seconds consumed: at 0 this is pure
        earliest-completion (the greedy's rule); at higher values jobs
        prefer efficient sub-linear-scaling configs, freeing capacity
        for parallelism — the LNS samples beta per repair round, and
        simulated annealing keeps what helps.

        With ``target`` set (makespan-driven repair): among choices
        finishing by the target, take the cheapest GPU area — the
        balanced-allocation rule that packs toward a candidate makespan
        — falling back to earliest completion when none makes it."""
        best = None
        found = None
        for ci in range(len(self.ch_g[i])):
            g = int(self.ch_g[i][ci])
            rt = float(self.ch_rt[i][ci])
            t = tl.earliest_start(self.ch_pool[i][ci], g, rt)
            if t is None:
                continue
            if target is not None:
                meets = t + rt <= target + _EPS
                key = (not meets,
                       g * rt if meets else t + rt, t + rt, g, ci)
            else:
                key = (t + rt + beta * (g * rt) / self._cap_total,
                       g, ci)
            if best is None or key < best:
                best = key
                found = (ci, t, g, rt)
        if found is None:
            raise RuntimeError(
                f"LNS: job {self.jobs[i].name} fits no pool "
                f"(standing reservations exceed capacity?)")
        ci, t, g, rt = found
        tl.add(self.ch_pool[i][ci], t, t + rt, g)
        return ci, t

    def build(self, order: np.ndarray,
              ci_hint: Optional[np.ndarray] = None,
              beta: float = 0.0) -> _Plan:
        """Construct a feasible plan by inserting every job in ``order``
        (``ci_hint`` pins a job's choice where >= 0)."""
        tl = _Timeline(self.budgets, self.reserved)
        ci = np.zeros(self.n, dtype=np.int64)
        start = np.zeros(self.n)
        for i in order:
            i = int(i)
            hint = -1 if ci_hint is None else int(ci_hint[i])
            if hint >= 0:
                g = int(self.ch_g[i][hint])
                rt = float(self.ch_rt[i][hint])
                t = tl.earliest_start(self.ch_pool[i][hint], g, rt)
                if t is not None:
                    tl.add(self.ch_pool[i][hint], t, t + rt, g)
                    ci[i], start[i] = hint, t
                    continue
            ci[i], start[i] = self.insert(tl, i, beta=beta)
        return _Plan(ci, start)

    def from_assignments(self, assignments: Iterable[Assignment]
                         ) -> Optional[_Plan]:
        """Adopt an external plan (greedy seed / previous incremental
        plan): match each assignment to a choice and re-insert in start
        order, pinning the matched choices — always feasible, and equal
        to the source plan whenever that plan was left-justified."""
        byname = {j.name: i for i, j in enumerate(self.jobs)}
        ci_hint = np.full(self.n, -1, dtype=np.int64)
        start_hint = np.full(self.n, np.inf)
        for a in assignments:
            i = byname.get(a.job)
            if i is None:
                continue
            for ci, c in enumerate(self.choice_map[a.job]):
                if c.technique == a.technique and c.n_gpus == a.n_gpus \
                        and c.device_class == a.device_class:
                    ci_hint[i] = ci
                    start_hint[i] = a.start_s
                    break
        # jobs the source plan did not cover insert last, greedily
        order = np.argsort(np.where(np.isfinite(start_hint),
                                    start_hint, np.inf), kind="stable")
        return self.build(order, ci_hint=ci_hint)


# ------------------------------------------------- destroy neighborhoods

_NEIGHBORHOODS = ("random", "worst", "window", "pool")


def _destroy(state: LnsState, plan: _Plan, ends: np.ndarray,
             rng: np.random.RandomState) -> np.ndarray:
    """Pick a neighborhood and return the boolean removal mask."""
    n = state.n
    k = max(2, min(n, int(math.ceil(n * rng.uniform(0.1, 0.35)))))
    kind = _NEIGHBORHOODS[rng.randint(len(_NEIGHBORHOODS))]
    mask = np.zeros(n, dtype=bool)
    if kind == "random" or n <= 2:
        mask[rng.choice(n, size=k, replace=False)] = True
        return mask
    if kind == "worst":
        # per-job contribution under the active objective (ends for
        # makespan/fair-share, weighted ends for completion, weighted
        # lateness for tardiness) + noise so ties break differently
        if state.objective == "weighted_completion":
            contrib = state.weight_arr * ends
        elif state.objective == "tardiness":
            dl = state.deadline_arr
            contrib = state.weight_arr * np.maximum(
                0.0, ends - np.where(np.isfinite(dl), dl, np.inf))
        else:
            contrib = ends.astype(np.float64)
        contrib = contrib + rng.uniform(0.0, 1.0, n) * \
            (1e-6 * max(contrib.max(), 1.0))
        mask[np.argsort(-contrib, kind="stable")[:k]] = True
        return mask
    if kind == "window":
        # jobs finishing inside a window below the makespan: the
        # critical tail the incumbent cannot shorten without moving them
        mk = float(ends.max())
        w = rng.uniform(0.15, 0.45) * max(mk, _EPS)
        cand = np.flatnonzero(ends > mk - w)
        if cand.size > 2 * k:
            cand = cand[np.argsort(-ends[cand], kind="stable")[:2 * k]]
        if cand.size >= 2:
            mask[cand] = True
            return mask
        mask[rng.choice(n, size=k, replace=False)] = True
        return mask
    # "pool": every job currently drawing from one budget pool (on a
    # flat cluster there is one pool, which degrades to a large-random)
    pools = sorted(state.budgets.keys(), key=lambda p: (p is None, p))
    p = pools[rng.randint(len(pools))]
    cand = np.flatnonzero(np.array(
        [state.ch_pool[i][plan.ci[i]] == p for i in range(n)]))
    if cand.size < 2:
        mask[rng.choice(n, size=k, replace=False)] = True
        return mask
    if cand.size > 2 * k:
        cand = rng.choice(cand, size=2 * k, replace=False)
    mask[cand] = True
    return mask


# per-round GPU-area penalties the repair samples from: 0 is the pure
# earliest-completion greedy rule; the higher values steer removed jobs
# onto efficient (sub-linear-scaling) configs so more of them overlap
_BETAS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0)


def _repair(state: LnsState, plan: _Plan, mask: np.ndarray,
            rng: np.random.RandomState,
            target: Optional[float] = None) -> _Plan:
    """Reinsert the removed jobs onto the kept jobs' timeline.  Order is
    the objective rank most rounds, a random permutation otherwise; the
    insertion rule alternates between an area-penalized earliest-fit
    (``beta`` sampled per round) and, when a ``target`` value is known,
    a deadline-driven rule (cheapest area finishing by the target)."""
    out = plan.copy()
    tl = state.timeline_of(plan, skip=mask)
    beta = _BETAS[rng.randint(len(_BETAS))]
    if target is not None and rng.random_sample() < 0.5:
        target = target * rng.uniform(0.8, 1.0)
    else:
        target = None
    removed = [int(i) for i in state.rank if mask[int(i)]]
    if rng.random_sample() < 0.3:
        removed = [removed[k] for k in rng.permutation(len(removed))]
    for i in removed:
        out.ci[i], out.start[i] = state.insert(tl, i, beta=beta,
                                               target=target)
    return out


def lns_solve(jobs: List[Job], choice_map: Dict[str, List[Choice]],
              budgets: Dict[Optional[str], int], *,
              reserved: Iterable[Tuple] = (),
              objective: str = "makespan",
              deadline_s: float = 10.0,
              max_iters: Optional[int] = None,
              seed: int = 0,
              incumbent: Optional[List[Assignment]] = None,
              gap_target: Optional[float] = None,
              lower_bound: Optional[float] = None,
              stop=None) -> Solution:
    """Deadline-bounded LNS over interval time.  Anytime: returns the
    best plan found, never worse than the greedy seed under
    ``objective``.

    ``incumbent`` seeds the search with a previous plan's assignments
    (the incremental-replan warm start) — adopted when it scores better
    than the greedy seed.  ``gap_target`` + ``lower_bound`` enable the
    portfolio's first-to-gap early exit; ``stop`` (a
    ``threading.Event``-alike) aborts between iterations when another
    backend already won.  Same ``seed`` + an iteration budget that binds
    before ``deadline_s`` -> bit-identical plans.
    """
    t0 = time.perf_counter()
    if not jobs:
        return Solution([], 0.0, "lns",
                        telemetry={"backend": "lns", "wall_s": 0.0,
                                   "gap": None, "status": "empty",
                                   "iters": 0, "n_jobs": 0})
    state = LnsState(jobs, choice_map, budgets, reserved=reserved,
                     objective=objective)
    rng = np.random.RandomState(seed)

    greedy = greedy_schedule(jobs, choice_map, budgets,
                             reserved=list(reserved), objective=objective)
    cur = state.from_assignments(greedy.assignments)
    cur_val = state.value(cur)
    # constructive seed sweep: one earliest-fit build per area penalty —
    # a balanced-area build often beats the list-scheduler greedy
    # outright, and each build is a single O(n * E) insertion pass
    for beta in _BETAS:
        alt = state.build(state.rank, beta=beta)
        alt_val = state.value(alt)
        if alt_val < cur_val:
            cur, cur_val = alt, alt_val
    if incumbent:
        alt = state.from_assignments(incumbent)
        alt_val = state.value(alt)
        if alt_val < cur_val:
            cur, cur_val = alt, alt_val
    best, best_val = cur.copy(), cur_val

    def gap_of(v: float) -> Optional[float]:
        if lower_bound is None or objective != "makespan":
            return None
        return max(0.0, v - lower_bound) / max(v, _EPS)

    status = "deadline"
    it = 0
    limit = max_iters if max_iters is not None else 10_000_000
    T0 = 0.05 * max(cur_val, _EPS)
    g = gap_of(best_val)
    if gap_target is not None and g is not None and g <= gap_target:
        status, limit = "gap_target", 0      # seed already good enough
    while it < limit:
        if stop is not None and stop.is_set():
            status = "stopped"
            break
        if time.perf_counter() - t0 >= deadline_s:
            status = "deadline"
            break
        ends = state.ends(cur)
        mask = _destroy(state, cur, ends, rng)
        cand = _repair(state, cur, mask, rng,
                       target=best_val if objective == "makespan"
                       else None)
        cand_val = state.value(cand)
        temp = max(T0 * (0.995 ** it), 1e-12)
        dv = cand_val - cur_val
        if dv < 0 or rng.random_sample() < math.exp(
                -min(dv / temp, 700.0)):
            cur, cur_val = cand, cand_val
        if cand_val < best_val - _EPS:
            best, best_val = cand.copy(), cand_val
            g = gap_of(best_val)
            if gap_target is not None and g is not None \
                    and g <= gap_target:
                status = "gap_target"
                it += 1
                break
        it += 1
    else:
        status = "max_iters" if limit > 0 else status

    assignments = []
    for i, j in enumerate(jobs):
        c = choice_map[j.name][int(best.ci[i])]
        assignments.append(Assignment(j.name, c.technique, c.n_gpus,
                                      float(best.start[i]), c.runtime_s,
                                      device_class=c.device_class))
    mk = max(a.end_s for a in assignments)
    wall = time.perf_counter() - t0
    return Solution(
        assignments, mk, "lns",
        telemetry={"backend": "lns", "wall_s": wall,
                   "gap": gap_of(best_val), "status": status,
                   "iters": it, "n_jobs": state.n,
                   "value": float(best_val)})
