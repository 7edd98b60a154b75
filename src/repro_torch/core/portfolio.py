"""Solver portfolio: pluggable backends racing under one wall budget.

ROADMAP item 3 (and the opmed ADR-001 in SNIPPETS.md) calls for an
interval-variable solver next to the time-indexed MILP, raced per
replan — first engine to reach the gap target wins.  This module is
that seam:

- :class:`SolverBackend` is the protocol extracted from the
  ``solve_joint`` / ``solve_joint_classes`` call shape: jobs + per-job
  ``Choice`` lists + per-pool budgets + ``reserved=`` capacity triples
  + ``objective=`` in, a :class:`~repro_torch.core.solver.Solution` (Schedule
  IR via ``to_schedule()``) with telemetry ``{backend, wall_s, gap,
  status}`` out.
- :class:`MilpRefinedBackend` wraps the existing coarse-to-fine
  time-indexed MILP; :class:`LnsBackend` wraps the interval-time LNS
  (:mod:`repro_torch.core.lns`).
- :class:`CpSatBackend` is the OR-Tools CP-SAT interval-variable
  formulation, registered ONLY when ``ortools`` imports: the package
  cannot be installed in this environment (no network wheel), so it is
  an optional slot, never a dependency — the LNS delivers the
  interval-time representation with pure numpy.
- :func:`solve_portfolio` races backends in threads under a shared
  wall budget against the area/critical-path lower bound
  (:func:`makespan_lower_bound`): the first backend whose incumbent
  closes to ``gap_target`` wins and the rest are signalled to stop;
  otherwise the best incumbent at the deadline wins (deterministic
  tie-break on backend order).

scipy's HiGHS holds the GIL for the whole branch-and-bound, so inside
a race the MILP backend solves in a forked child process (see
:class:`MilpRefinedBackend`) — the LNS thread runs unstarved and a
losing MILP is actually killed, not abandoned.  Callers that measure
wall time back-to-back (the solver bench) still call
:func:`join_stragglers` between measurements to drain the watcher
threads.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

from .job import Job
from .lns import lns_solve
from .solver import (Assignment, Choice, OBJECTIVES, Solution,
                     _solve_refined, greedy_schedule, objective_value)

try:                                   # optional: see module docstring
    from ortools.sat.python import cp_model
    HAVE_ORTOOLS = True
except Exception:                      # pragma: no cover - not installed
    cp_model = None
    HAVE_ORTOOLS = False


def makespan_lower_bound(jobs: List[Job],
                         choice_map: Dict[str, List[Choice]],
                         budgets: Dict[Optional[str], int]) -> float:
    """A valid makespan lower bound: max of the critical job (every job
    needs at least its fastest runtime) and the GPU-area bound (total
    minimum GPU-seconds over total capacity).  Reservations are ignored
    — they only shrink capacity, so this stays a true lower bound."""
    if not jobs:
        return 0.0
    t_min = max(min(c.runtime_s for c in choice_map[j.name])
                for j in jobs)
    area = sum(min(c.n_gpus * c.runtime_s for c in choice_map[j.name])
               for j in jobs)
    cap = max(sum(budgets.values()), 1)
    return max(t_min, area / cap)


class SolverBackend:
    """One engine in the portfolio.  Subclasses implement :meth:`solve`
    with the shared call shape; ``name`` keys the registry and the
    telemetry's ``backend`` field."""

    name = "base"

    def solve(self, jobs: List[Job],
              choice_map: Dict[str, List[Choice]],
              budgets: Dict[Optional[str], int], *,
              reserved: Iterable[Tuple] = (),
              objective: str = "makespan",
              time_limit_s: float = 10.0,
              gap_target: float = 0.05,
              seed: int = 0,
              warm_starts: Optional[Dict[str, float]] = None,
              incumbent: Optional[List[Assignment]] = None,
              lower_bound: Optional[float] = None,
              stop=None) -> Solution:
        raise NotImplementedError


SOLVER_BACKENDS: Dict[str, type] = {}


def register_backend(cls):
    """Class decorator: make a backend addressable by name in
    :func:`solve_portfolio`'s ``backends=`` list."""
    SOLVER_BACKENDS[cls.name] = cls
    return cls


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(SOLVER_BACKENDS))


def _milp_entry(payload: tuple) -> Solution:
    """The actual MILP solve — shared by the in-process and child-process
    paths, so both are bit-identical."""
    (jobs, choice_map, budgets, ub, n_slots, coarse_slots, time_limit_s,
     gap, objective, reserved, warm_starts) = payload
    if warm_starts:
        from .solver import _solve_time_indexed
        horizon = max(ub.makespan_s, 1e-6) * 1.05
        return _solve_time_indexed(
            jobs, choice_map, budgets, ub, "milp", n_slots=n_slots,
            time_limit_s=time_limit_s, mip_gap=gap, horizon=horizon,
            start_windows=warm_starts, window_pad_s=horizon / 8.0,
            reserved=reserved, objective=objective)
    return _solve_refined(
        jobs, choice_map, budgets, ub, "milp", n_slots=n_slots,
        coarse_slots=coarse_slots, time_limit_s=time_limit_s,
        mip_gap=gap, objective=objective, reserved=reserved)


def _milp_child(conn, payload) -> None:    # pragma: no cover - subprocess
    try:
        conn.send(("ok", _milp_entry(payload)))
    except Exception as e:
        conn.send(("err", repr(e)))
    finally:
        conn.close()


@register_backend
class MilpRefinedBackend(SolverBackend):
    """The existing coarse-to-fine time-indexed MILP as a portfolio
    engine.  ``warm_starts`` (job -> previous planned start) switches to
    the windowed single-grid solve the incremental replan uses.

    scipy's HiGHS wrapper holds the GIL for the whole branch-and-bound
    (measured: a 1 ms-sleep spinner thread gets ~3 ticks/s next to a
    grinding solve), so racing it in a thread would starve the LNS.
    When a ``stop`` event is supplied (i.e. inside a race) the solve
    runs in a forked child process instead: the GIL is uncontended and
    the race can actually *cancel* the MILP the moment another backend
    wins.  Direct calls (``stop=None``) solve in-process — no fork
    overhead, same answer (:func:`_milp_entry` is shared)."""

    name = "milp"

    def __init__(self, n_slots: int = 24, coarse_slots: int = 8):
        self.n_slots = n_slots
        self.coarse_slots = coarse_slots

    def solve(self, jobs, choice_map, budgets, *, reserved=(),
              objective="makespan", time_limit_s=10.0, gap_target=0.05,
              seed=0, warm_starts=None, incumbent=None,
              lower_bound=None, stop=None) -> Solution:
        t0 = time.perf_counter()
        reserved = list(reserved)
        ub = greedy_schedule(jobs, choice_map, budgets,
                             reserved=reserved, objective=objective)
        payload = (jobs, choice_map, budgets, ub, self.n_slots,
                   self.coarse_slots, time_limit_s, gap_target,
                   objective, reserved, warm_starts)
        status = None
        if stop is None:
            sol = _milp_entry(payload)
        else:
            sol, status = self._solve_forked(payload, ub, stop,
                                             t0 + time_limit_s + 5.0)
        sol.telemetry = {"backend": self.name,
                         "wall_s": time.perf_counter() - t0,
                         "gap": None, "status": status
                         or sol.milp_status or sol.solver,
                         "n_jobs": len(jobs)}
        return sol

    @staticmethod
    def _solve_forked(payload, ub: Solution, stop,
                      deadline: float) -> Tuple[Solution, Optional[str]]:
        """Run :func:`_milp_entry` in a forked child; fall back to the
        greedy bound if stopped/killed, to in-process if fork is
        unavailable (non-Linux)."""
        try:
            ctx = multiprocessing.get_context("fork")
        except ValueError:              # pragma: no cover - non-Linux
            return _milp_entry(payload), None
        parent, child = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_milp_child, args=(child, payload),
                           daemon=True)
        proc.start()
        child.close()
        try:
            while True:
                if parent.poll(0.1):
                    try:
                        tag, obj = parent.recv()
                    except EOFError:    # child died without sending
                        return ub, "error"
                    return (obj, None) if tag == "ok" else (ub, "error")
                if stop.is_set():
                    proc.terminate()
                    return ub, "stopped"
                if time.perf_counter() > deadline:
                    proc.terminate()
                    return ub, "timeout"
        finally:
            parent.close()
            proc.join(1.0)
            if proc.is_alive():         # pragma: no cover
                proc.kill()
                proc.join(1.0)


@register_backend
class LnsBackend(SolverBackend):
    """The interval-time LNS (:func:`repro_torch.core.lns.lns_solve`) as a
    portfolio engine.  ``incumbent`` seeds the search with the previous
    plan; ``stop`` aborts between iterations when another backend wins."""

    name = "lns"

    def __init__(self, max_iters: Optional[int] = None):
        self.max_iters = max_iters

    def solve(self, jobs, choice_map, budgets, *, reserved=(),
              objective="makespan", time_limit_s=10.0, gap_target=0.05,
              seed=0, warm_starts=None, incumbent=None,
              lower_bound=None, stop=None) -> Solution:
        return lns_solve(jobs, choice_map, budgets, reserved=reserved,
                         objective=objective, deadline_s=time_limit_s,
                         max_iters=self.max_iters, seed=seed,
                         incumbent=incumbent, gap_target=gap_target,
                         lower_bound=lower_bound, stop=stop)


class CpSatBackend(SolverBackend):
    """OR-Tools CP-SAT interval-variable formulation (opmed ADR-001):
    one optional interval per (job, choice) + ``AddCumulative`` per
    budget pool — no slot grid, exact integer starts at ``_SCALE``
    resolution.  Registered only when ``ortools`` imports; this
    environment cannot install it, so the class is exercised by CI only
    as a guarded-import skip (see tests/test_portfolio.py)."""

    name = "cpsat"
    _SCALE = 100          # integer time unit = 10 ms

    def solve(self, jobs, choice_map, budgets, *, reserved=(),
              objective="makespan", time_limit_s=10.0, gap_target=0.05,
              seed=0, warm_starts=None, incumbent=None,
              lower_bound=None, stop=None) -> Solution:
        if cp_model is None:            # pragma: no cover
            raise RuntimeError("ortools is not installed; the CP-SAT "
                               "backend is an optional slot")
        t0 = time.perf_counter()
        reserved = list(reserved)
        ub = greedy_schedule(jobs, choice_map, budgets,
                             reserved=reserved, objective=objective)
        horizon = int(math.ceil(max(
            [ub.makespan_s * 1.05] + [r for _, _, r in reserved
                                      if math.isfinite(r)]
        ) * self._SCALE)) + 1
        m = cp_model.CpModel()
        per_pool: Dict[Optional[str], list] = {p: [] for p in budgets}
        ends, lits_of = [], {}
        for j in jobs:
            lits, j_end = [], m.NewIntVar(0, horizon, f"end_{j.name}")
            for ci, c in enumerate(choice_map[j.name]):
                lit = m.NewBoolVar(f"x_{j.name}_{ci}")
                dur = max(1, int(round(c.runtime_s * self._SCALE)))
                s = m.NewIntVar(0, horizon, f"s_{j.name}_{ci}")
                iv = m.NewOptionalIntervalVar(
                    s, dur, s + dur, lit, f"iv_{j.name}_{ci}")
                pool = c.device_class if c.device_class in budgets \
                    else None
                per_pool[pool].append((iv, c.n_gpus))
                m.Add(j_end == s + dur).OnlyEnforceIf(lit)
                lits.append(lit)
            m.AddExactlyOne(lits)
            lits_of[j.name] = lits
            ends.append((j, j_end))
        for dc, g, release_s in reserved:
            pool = dc if dc in budgets else None
            until = horizon if not math.isfinite(release_s) \
                else max(1, int(round(release_s * self._SCALE)))
            per_pool[pool].append(
                (m.NewIntervalVar(0, until, until, f"res_{dc}_{g}"),
                 int(g)))
        for pool, ivs in per_pool.items():
            if ivs:
                m.AddCumulative([iv for iv, _ in ivs],
                                [g for _, g in ivs], budgets[pool])
        if objective in ("makespan", "fair_share"):
            M = m.NewIntVar(0, horizon, "M")
            if objective == "makespan":
                m.AddMaxEquality(M, [e for _, e in ends])
            else:
                per_ten: Dict[str, list] = {}
                for j, e in ends:
                    per_ten.setdefault(
                        getattr(j, "tenant", "default"), []).append(e)
                for es in per_ten.values():
                    m.Add(M * len(es) >= sum(es))
            m.Minimize(M)
        elif objective == "weighted_completion":
            m.Minimize(sum(int(round(getattr(j, "weight", 1.0) * 1000))
                           * e for j, e in ends))
        else:   # tardiness
            lates = []
            for j, e in ends:
                dl = getattr(j, "deadline_s", None)
                if dl is None:
                    continue
                late = m.NewIntVar(0, horizon, f"late_{j.name}")
                m.Add(late >= e - int(round(dl * self._SCALE)))
                lates.append(
                    int(round(getattr(j, "weight", 1.0) * 1000)) * late)
            m.Minimize(sum(lates) if lates else 0)
        solver = cp_model.CpSolver()
        solver.parameters.max_time_in_seconds = time_limit_s
        solver.parameters.relative_gap_limit = gap_target
        solver.parameters.random_seed = seed
        status = solver.Solve(m)
        if status not in (cp_model.OPTIMAL, cp_model.FEASIBLE):
            ub.telemetry = {"backend": self.name,
                            "wall_s": time.perf_counter() - t0,
                            "gap": None, "status": "infeasible",
                            "n_jobs": len(jobs)}
            return ub
        assignments = []
        for j in jobs:
            for ci, lit in enumerate(lits_of[j.name]):
                if solver.Value(lit):
                    c = choice_map[j.name][ci]
                    end = solver.Value(
                        [e for jj, e in ends if jj is j][0])
                    dur = max(1, int(round(c.runtime_s * self._SCALE)))
                    assignments.append(Assignment(
                        j.name, c.technique, c.n_gpus,
                        (end - dur) / self._SCALE, c.runtime_s,
                        device_class=c.device_class))
                    break
        mk = max(a.end_s for a in assignments)
        sol = Solution(assignments, mk, "cpsat",
                       milp_status=solver.StatusName(status))
        sol.telemetry = {"backend": self.name,
                         "wall_s": time.perf_counter() - t0,
                         "gap": None,
                         "status": solver.StatusName(status),
                         "n_jobs": len(jobs)}
        return sol


if HAVE_ORTOOLS:                       # pragma: no cover - optional dep
    register_backend(CpSatBackend)


# threads abandoned by an early-exiting race (HiGHS cannot be stopped
# mid-solve); join_stragglers() drains them before wall-sensitive work
_STRAGGLERS: List[threading.Thread] = []
_STRAGGLERS_LOCK = threading.Lock()


def join_stragglers(timeout: Optional[float] = None) -> None:
    """Wait for backend threads a finished race left running (bench
    hygiene: a grinding MILP thread would pollute the next tier's wall
    clock)."""
    with _STRAGGLERS_LOCK:
        pending, _STRAGGLERS[:] = _STRAGGLERS[:], []
    for t in pending:
        t.join(timeout)
        if t.is_alive():                # pragma: no cover
            with _STRAGGLERS_LOCK:
                _STRAGGLERS.append(t)


def solve_portfolio(jobs: List[Job],
                    choice_map: Dict[str, List[Choice]],
                    budgets: Dict[Optional[str], int], *,
                    reserved: Iterable[Tuple] = (),
                    objective: str = "makespan",
                    wall_budget_s: float = 10.0,
                    gap_target: float = 0.05,
                    seed: int = 0,
                    warm_starts: Optional[Dict[str, float]] = None,
                    incumbent: Optional[List[Assignment]] = None,
                    backends: Iterable[Union[str, SolverBackend]]
                    = ("milp", "lns")) -> Solution:
    """Race solver backends in threads under a shared wall budget.

    Every backend gets the full problem (jobs, choices, budgets,
    ``reserved`` triples, objective) plus the shared lower bound and a
    stop signal.  The first backend whose result closes to
    ``gap_target`` of :func:`makespan_lower_bound` wins immediately
    (the others are told to stop); otherwise the best finished incumbent
    under ``objective`` at the deadline wins, ties broken by backend
    order.  Falls back to the greedy bound if every backend errors.

    Returns the winning Solution renamed ``portfolio[<solver>]`` with
    ``telemetry = {backend, wall_s, gap, status, n_jobs, engines}``
    where ``engines`` holds each finisher's own telemetry.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"expected one of {OBJECTIVES}")
    t0 = time.perf_counter()
    reserved = list(reserved)
    if not jobs:
        return Solution([], 0.0, "portfolio[empty]",
                        telemetry={"backend": "none", "wall_s": 0.0,
                                   "gap": None, "status": "empty",
                                   "n_jobs": 0, "engines": {}})
    bes: List[SolverBackend] = []
    for b in backends:
        bes.append(SOLVER_BACKENDS[b]() if isinstance(b, str) else b)
    lb = makespan_lower_bound(jobs, choice_map, budgets) \
        if objective == "makespan" else None

    def gap_of(val: float) -> Optional[float]:
        if lb is None:
            return None
        return max(0.0, val - lb) / max(val, 1e-9)

    stop = threading.Event()
    done = threading.Condition()
    results: Dict[str, Solution] = {}
    failed: List[str] = []
    winner: List[str] = []

    def run(be: SolverBackend) -> None:
        try:
            sol = be.solve(jobs, choice_map, budgets, reserved=reserved,
                           objective=objective,
                           time_limit_s=wall_budget_s,
                           gap_target=gap_target, seed=seed,
                           warm_starts=warm_starts, incumbent=incumbent,
                           lower_bound=lb, stop=stop)
        except Exception:
            sol = None
        with done:
            if sol is None:
                failed.append(be.name)
            else:
                results[be.name] = sol
                g = gap_of(objective_value(sol.assignments, jobs,
                                           objective))
                if g is not None and g <= gap_target + 1e-12 \
                        and not winner:
                    winner.append(be.name)
                    stop.set()
            done.notify_all()

    threads = [threading.Thread(target=run, args=(be,), daemon=True,
                                name=f"portfolio-{be.name}")
               for be in bes]
    for t in threads:
        t.start()
    deadline = t0 + wall_budget_s + 2.0     # grace for thread overhead
    with done:
        while not winner and len(results) + len(failed) < len(bes):
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            done.wait(timeout=min(left, 0.2))
    stop.set()
    with _STRAGGLERS_LOCK:
        _STRAGGLERS.extend(t for t in threads if t.is_alive())

    with done:
        got = dict(results)
    if not got:         # every backend failed or overran: greedy bound
        sol = greedy_schedule(jobs, choice_map, budgets,
                              reserved=reserved, objective=objective)
        got = {"greedy": sol}
    order = {be.name: i for i, be in enumerate(bes)}
    vals = {name: objective_value(s.assignments, jobs, objective)
            for name, s in got.items()}
    if winner:
        pick = winner[0]
    else:
        pick = min(got, key=lambda n: (vals[n], order.get(n, 99)))
    sol = got[pick]
    wall = time.perf_counter() - t0
    engines = {name: (s.telemetry or {"backend": name})
               for name, s in got.items()}
    tel = {"backend": pick, "wall_s": wall, "gap": gap_of(vals[pick]),
           "status": "gap_target" if winner else "deadline",
           "n_jobs": len(jobs), "engines": engines}
    out = dataclasses.replace(sol, solver=f"portfolio[{sol.solver}]")
    out.telemetry = tel
    return out
