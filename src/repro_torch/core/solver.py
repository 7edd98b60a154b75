"""Saturn's joint Solver (paper §2): parallelism selection + GPU
allocation + scheduling as one mixed-integer linear program.

Time-indexed formulation (the tech-report formulation, Gurobi swapped
for HiGHS via ``scipy.optimize.milp`` — same MILP, different solver):

  binaries  x[j,c,t]  — job j starts config c = (technique, g, duration)
                         at time slot t
  continuous M         — makespan

  min  M + eps * sum t*x                    (eps tie-breaks earlier starts)
  s.t. sum_{c,t} x[j,c,t] = 1               for every job j
       sum_{j,c} g_c * sum_{t in (tau-d_c, tau]} x[j,c,t] <= cap(pool, tau)
       sum_{c,t} (t + d_jc) * delta * x[j,c,t] <= M     for every job j

(The makespan rows are aggregated per job: with the assignment equality
in place the weighted sum equals the chosen end exactly, and the LP
relaxation is *tighter* than one big-M row per binary — n_jobs rows
instead of one per variable.)

The scheduling core is built for scale:

- Constraint assembly is fully vectorized: per-variable attributes live
  in flat numpy arrays and every constraint family is emitted as one
  bulk COO block (``_MilpBuilder.add_block``) — no per-term Python
  loops, so assembly stays negligible next to the solve itself.
- ``refine=True`` runs a coarse-to-fine pass: solve on a coarse slot
  grid first, then re-solve on the fine grid with each job's start
  variables restricted to a window around the coarse incumbent's start
  — cutting the binary count roughly ``n_slots / coarse_slots``-fold.
- :func:`solve_residual` is the warm-started incremental replan: jobs
  that are running and provably not worth preempting become capacity
  *reservations* instead of variables, the previous solution's start
  times seed per-job refinement windows, and the greedy bound is
  installed as an upper bound on the makespan variable so HiGHS can
  early-exit on gap.

The flat MILP (``solve_joint``), the class-aware MILP
(``solve_joint_classes``) and the node-locality MILP
(``solve_joint_nodes``) share the one builder and all emit Schedule IR
via :meth:`Solution.to_schedule`.

Beyond the paper's makespan objective, the flat/class/incremental
solvers accept ``objective=`` (see ``OBJECTIVES``): weighted completion
time, weighted tardiness against per-job deadlines, and per-tenant fair
share (minimize the worst tenant's mean completion) — all linear in the
same start binaries, so no extra variables are introduced.

A greedy list-scheduling fallback guards against solver timeouts (and is
also used to compute an upper bound that sizes the horizon).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
from scipy import sparse
from scipy.optimize import LinearConstraint, milp, Bounds

from .job import Job
from .profiler import Profile
from .schedule import Schedule, ScheduleEntry


@contextlib.contextmanager
def _quiet_stdout():
    """HiGHS prints C-level debug lines; mute fd 1 during the solve."""
    try:
        saved = os.dup(1)
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, 1)
        yield
    finally:
        os.dup2(saved, 1)
        os.close(saved)
        os.close(devnull)


@dataclasses.dataclass(frozen=True)
class Choice:
    """One point in a job's config space."""
    technique: str
    n_gpus: int
    runtime_s: float          # total remaining runtime under this config
    device_class: Optional[str] = None   # class-qualified (hetero) choices


@dataclasses.dataclass
class Assignment:
    job: str
    technique: str
    n_gpus: int
    start_s: float
    runtime_s: float
    nodes: Optional[Tuple[int, ...]] = None   # node-aware MILP only
    device_class: Optional[str] = None        # class-aware MILP only

    @property
    def end_s(self) -> float:
        return self.start_s + self.runtime_s


@dataclasses.dataclass
class Solution:
    assignments: List[Assignment]
    makespan_s: float
    solver: str     # "milp" | "milp-nodes" | "milp-classes" |
    #                 "milp-incremental" | "greedy" | "greedy-incremental" |
    #                 "lns" | "portfolio[...]"
    milp_status: Optional[str] = None
    # solver telemetry {backend, wall_s, gap, status, ...} — filled by the
    # portfolio/LNS backends and surfaced via Schedule into
    # SimResult.stats["solver"] so callers stop re-deriving which engine
    # won and whether it capped
    telemetry: Optional[dict] = None

    def order(self) -> List[Assignment]:
        return sorted(self.assignments, key=lambda a: (a.start_s, a.job))

    def to_schedule(self) -> Schedule:
        """Emit Schedule IR: the typed contract the runtime executes."""
        entries = [ScheduleEntry(a.job, a.technique, a.n_gpus,
                                 start_s=a.start_s, runtime_s=a.runtime_s,
                                 nodes=a.nodes, device_class=a.device_class)
                   for a in self.order()]
        return Schedule(entries, solver=self.solver,
                        makespan_s=self.makespan_s,
                        telemetry=self.telemetry)


def _pool_of(choice: Choice, budgets) -> Optional[str]:
    """Which budget pool a choice draws from: its device class when that
    class has its own budget, else the pooled ``None`` key."""
    return choice.device_class if choice.device_class in budgets else None


# ------------------------------------------------- alternative objectives

# Every objective is linear in the start binaries (each binary encodes a
# complete (config, start) decision, so its end time — and therefore its
# completion cost or lateness — is a CONSTANT coefficient), which is why
# none of them needs extra MILP variables:
#
# - "makespan"             min M,             M >= end_j            (paper)
# - "weighted_completion"  min sum w_j * end_j
# - "tardiness"            min sum w_j * max(0, end_j - deadline_j)
# - "fair_share"           min M,  M >= avg end over each tenant's jobs
#                          (minimize the WORST tenant's mean completion)
OBJECTIVES = ("makespan", "weighted_completion", "tardiness", "fair_share")


def _weight(j) -> float:
    return float(getattr(j, "weight", 1.0))


def _deadline(j) -> float:
    d = getattr(j, "deadline_s", None)
    return math.inf if d is None else float(d)


def objective_value(assignments: Iterable[Assignment], jobs: List[Job],
                    objective: str = "makespan") -> float:
    """Score a plan under an objective (lower is better).  Jobs absent
    from ``assignments`` contribute nothing — callers compare plans over
    the same job set."""
    ends = {a.job: a.end_s for a in assignments}
    if objective == "makespan":
        return max(ends.values(), default=0.0)
    if objective == "weighted_completion":
        return sum(_weight(j) * ends[j.name] for j in jobs
                   if j.name in ends)
    if objective == "tardiness":
        tot = 0.0
        for j in jobs:
            if j.name in ends and math.isfinite(_deadline(j)):
                tot += _weight(j) * max(0.0, ends[j.name] - _deadline(j))
        return tot
    if objective == "fair_share":
        per: Dict[str, List[float]] = {}
        for j in jobs:
            if j.name in ends:
                per.setdefault(getattr(j, "tenant", "default"),
                               []).append(ends[j.name])
        return max((sum(v) / len(v) for v in per.values()), default=0.0)
    raise ValueError(f"unknown objective {objective!r}; "
                     f"expected one of {OBJECTIVES}")


def objective_arrays(jobs: List[Job]) -> Dict[str, np.ndarray]:
    """Per-job numpy arrays (weights, deadlines, tenant one-hot) for
    :func:`objective_values_batch` — precompute once, score many
    candidate plans.  Row order follows ``jobs``."""
    n = len(jobs)
    w = np.array([_weight(j) for j in jobs], dtype=np.float64)
    dl = np.array([_deadline(j) for j in jobs], dtype=np.float64)
    tenants = sorted({getattr(j, "tenant", "default") for j in jobs})
    tix = {t: i for i, t in enumerate(tenants)}
    onehot = np.zeros((n, max(len(tenants), 1)), dtype=np.float64)
    for i, j in enumerate(jobs):
        onehot[i, tix[getattr(j, "tenant", "default")]] = 1.0
    counts = np.maximum(onehot.sum(axis=0), 1.0)
    return {"weight": w, "deadline": dl, "tenant_onehot": onehot,
            "tenant_counts": counts}


def objective_values_batch(ends, jobs: Optional[List[Job]] = None,
                           objective: str = "makespan", *,
                           arrays: Optional[Dict[str, np.ndarray]] = None):
    """Vectorized :func:`objective_value` over candidate plans.

    ``ends`` is the per-job completion-time array — shape ``(n_jobs,)``
    for one plan (returns a float) or ``(n_plans, n_jobs)`` for a batch
    (returns a ``(n_plans,)`` array), column order following ``jobs``.
    Pass ``arrays=`` (from :func:`objective_arrays`) to amortize the
    per-job attribute extraction across calls — the LNS hot loop scores
    every destroy/repair candidate through here, so the per-plan cost is
    pure numpy with no Python per-job iteration.
    """
    arrs = arrays if arrays is not None else objective_arrays(jobs)
    E = np.atleast_2d(np.asarray(ends, dtype=np.float64))
    if E.shape[1] == 0:
        vals = np.zeros(E.shape[0])
    elif objective == "makespan":
        vals = E.max(axis=1)
    elif objective == "weighted_completion":
        vals = E @ arrs["weight"]
    elif objective == "tardiness":
        fin = np.isfinite(arrs["deadline"])
        late = np.maximum(0.0, E[:, fin] - arrs["deadline"][fin])
        vals = late @ arrs["weight"][fin]
    elif objective == "fair_share":
        vals = (E @ arrs["tenant_onehot"] / arrs["tenant_counts"]) \
            .max(axis=1)
    else:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"expected one of {OBJECTIVES}")
    return vals if np.ndim(ends) == 2 else float(vals[0])


# ------------------------------------------------- shared MILP machinery

class _MilpBuilder:
    """Accumulates sparse linear constraints + runs the HiGHS MILP.

    Both joint formulations are "binary start variables + one continuous
    makespan var"; this builder owns the shared mechanics (COO blocks,
    row bounds, bounds/integrality vectors, solver call) so the solvers
    only differ in which constraints they emit.  Constraints arrive as
    whole numpy blocks (:meth:`add_block`) — per-term Python loops are
    the scaling killer the vectorized assembly replaces.
    """

    def __init__(self, n_binary: int):
        self.n_binary = n_binary
        self.nvar = n_binary + 1          # + makespan, always last
        self.M_idx = n_binary
        self._row_chunks: List[np.ndarray] = []
        self._col_chunks: List[np.ndarray] = []
        self._val_chunks: List[np.ndarray] = []
        self._lb_chunks: List[np.ndarray] = []
        self._ub_chunks: List[np.ndarray] = []
        self._r = 0

    def add_block(self, rows, cols, vals, lbs, ubs) -> None:
        """Bulk-append constraint rows.  ``rows`` holds LOCAL row ids
        0..len(lbs)-1 (offset internally); ``cols``/``vals`` are the COO
        triplets, one entry per nonzero."""
        lbs = np.atleast_1d(np.asarray(lbs, dtype=np.float64))
        self._row_chunks.append(
            np.asarray(rows, dtype=np.int64) + self._r)
        self._col_chunks.append(np.asarray(cols, dtype=np.int64))
        self._val_chunks.append(np.asarray(vals, dtype=np.float64))
        self._lb_chunks.append(lbs)
        self._ub_chunks.append(np.atleast_1d(np.asarray(ubs, np.float64)))
        self._r += len(lbs)

    def add(self, terms: Iterable[Tuple[int, float]],
            lb: float, ub: float) -> None:
        """One constraint row: lb <= sum coef*x[col] <= ub."""
        terms = list(terms)
        self.add_block(np.zeros(len(terms), dtype=np.int64),
                       [c for c, _ in terms], [v for _, v in terms],
                       [lb], [ub])

    def solve(self, cvec: np.ndarray, *, time_limit_s: float,
              mip_gap: float, m_upper: float = np.inf):
        """Run HiGHS; returns the scipy result or None on failure.

        ``m_upper`` bounds the makespan variable — installing a known
        feasible makespan (e.g. the greedy incumbent's) lets the solver
        prune and exit early on gap."""
        A = sparse.coo_matrix(
            (np.concatenate(self._val_chunks),
             (np.concatenate(self._row_chunks),
              np.concatenate(self._col_chunks))),
            shape=(self._r, self.nvar)).tocsc()
        cons = LinearConstraint(A, np.concatenate(self._lb_chunks),
                                np.concatenate(self._ub_chunks))
        integrality = np.ones(self.nvar)
        integrality[self.M_idx] = 0
        bounds = Bounds(np.zeros(self.nvar),
                        np.concatenate([np.ones(self.n_binary),
                                        [m_upper]]))
        try:
            with _quiet_stdout():
                res = milp(c=cvec, constraints=cons,
                           integrality=integrality, bounds=bounds,
                           options={"time_limit": time_limit_s,
                                    "mip_rel_gap": mip_gap,
                                    "presolve": True})
        except Exception:
            return None
        # status 0 = optimal, 1 = iteration/time limit: a limit-hit run
        # still carries its best integral incumbent in res.x — keep it
        # (callers fall back to the greedy bound when it's worse anyway)
        if res.x is None or res.status not in (0, 1):
            return None
        return res


# --------------------------------------------------------- choice cache

class _ChoiceCache:
    """Memoizes the per-step-time (technique, g, step_time) sweep behind
    :func:`choices_from_profiles`, keyed on profiles-object identity.

    Replans re-derive the same choice lists on every introspection
    event; with a curve-backed PerfModel each derivation walks the whole
    dense count grid.  The cache pins a strong reference to each
    profiles object it has seen (so ``id()`` cannot be recycled
    underneath it) and invalidates on ``len()`` change — the way test
    fixtures and planners actually mutate profile dicts (adding keys).
    Replacing a value in place for an existing key is NOT detected;
    nothing in the repo does that.
    """

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._store: "OrderedDict[int, tuple]" = OrderedDict()

    def per_step(self, profiles, job_name: str,
                 device_class: Optional[str]) -> List[Tuple[str, int, float]]:
        from .perfmodel import iter_job_profiles
        key = id(profiles)
        n = len(profiles)
        ent = self._store.get(key)
        if ent is None or ent[0] is not profiles or ent[1] != n:
            ent = (profiles, n, {})
            self._store[key] = ent
            while len(self._store) > self.max_entries:
                self._store.popitem(last=False)
        else:
            self._store.move_to_end(key)   # LRU: hits refresh recency
        sub = ent[2]
        k = (job_name, device_class)
        if k not in sub:
            sub[k] = [(tech, g, p.step_time_s)
                      for tech, g, p in iter_job_profiles(
                          profiles, job_name, device_class=device_class)
                      if p.feasible]
        return sub[k]

    def clear(self) -> None:
        self._store.clear()


_CHOICE_CACHE = _ChoiceCache()


def clear_choice_cache() -> None:
    """Drop all memoized choice lists (test hook)."""
    _CHOICE_CACHE.clear()


def choices_from_profiles(job: Job, profiles, *, prune: bool = True,
                          device_class: Optional[str] = None
                          ) -> List[Choice]:
    """Feasible (technique, g) choices with total runtimes for one job.

    ``profiles`` is either the legacy exhaustive dict or a
    :class:`~repro_torch.core.perfmodel.PerfModel` — with a model, choices are
    evaluated straight off the throughput curves, so the MILP optimizes
    over every count in the model's grid even though only the anchor
    counts were actually profiled.  Enumeration goes through
    ``iter_job_profiles`` so the solver sees exactly the grid the
    policies see — and is memoized per (profiles identity, job, class),
    so introspection replans stop re-walking the curve grid.

    prune=True drops Pareto-dominated choices (same or more GPUs, same or
    worse runtime) — a large constant-factor MILP size reduction that
    does not change the optimum.
    """
    per_step = _CHOICE_CACHE.per_step(profiles, job.name, device_class)
    out = [Choice(tech, g, st * job.total_steps,
                  device_class=device_class)
           for tech, g, st in per_step]
    if prune and out:
        out.sort(key=lambda c: (c.n_gpus, c.runtime_s))
        kept: List[Choice] = []
        best_rt = math.inf
        for c in out:
            if c.runtime_s < best_rt - 1e-9:
                kept.append(c)
                best_rt = c.runtime_s
        out = kept
    return out


def pooled_choice_map(jobs: List[Job], profiles
                      ) -> Dict[str, List[Choice]]:
    """Per-job pruned choice lists on the single pooled budget; raises
    when a job has no feasible config (shared by the flat MILP and the
    incremental replan so both optimize over the same space)."""
    cm = {j.name: choices_from_profiles(j, profiles) for j in jobs}
    for j in jobs:
        if not cm[j.name]:
            raise ValueError(f"job {j.name}: no feasible (technique, g)")
    return cm


def class_choice_map(jobs: List[Job], profiles, classes
                     ) -> Tuple[Dict[str, List[Choice]],
                                Dict[Optional[str], int]]:
    """Per-job class-qualified choice lists + per-class budgets: each
    job's space is the union over device classes of its feasible
    choices ON that class, budget-filtered (shared by the class MILP
    and the incremental replan)."""
    budgets: Dict[Optional[str], int] = {dc.name: dc.total_gpus
                                         for dc in classes}
    cm: Dict[str, List[Choice]] = {}
    for j in jobs:
        cs: List[Choice] = []
        for dc in classes:
            cs.extend(choices_from_profiles(j, profiles,
                                            device_class=dc.name))
        cs = [c for c in cs if c.n_gpus <= budgets[c.device_class]]
        if not cs:
            raise ValueError(
                f"job {j.name}: no feasible (technique, g, class)")
        cm[j.name] = cs
    return cm, budgets


def _rank_jobs(jobs: List[Job], choices: Dict[str, List[Choice]],
               objective: str) -> List[Job]:
    """Greedy dispatch order per objective: longest-first for makespan
    and fair share, WSPT (weight over best runtime, densest first) for
    weighted completion, EDF for tardiness (deadline-free jobs last,
    longest first among them)."""
    best_rt = {j.name: min((c.runtime_s for c in choices[j.name]),
                           default=0.0) for j in jobs}
    if objective == "weighted_completion":
        return sorted(jobs, key=lambda j: -_weight(j)
                      / max(best_rt[j.name], 1e-9))
    if objective == "tardiness":
        return sorted(jobs,
                      key=lambda j: (_deadline(j), -best_rt[j.name]))
    return sorted(jobs, key=lambda j: -best_rt[j.name])


def greedy_schedule(jobs: List[Job], choices: Dict[str, List[Choice]],
                    total_gpus, reserved: Iterable[Tuple] = (),
                    objective: str = "makespan") -> Solution:
    """List scheduling: objective-ranked jobs (see :func:`_rank_jobs`),
    each on its best-throughput feasible choice that fits when it starts.

    ``total_gpus`` is either a single pooled budget (int — the legacy
    flat cluster) or per-device-class budgets (``{class_name: gpus}``);
    with budgets, each Choice draws from its own class's pool.

    ``reserved`` pre-loads running allocations the schedule must work
    around: ``(device_class_or_None, n_gpus, release_s)`` triples whose
    GPUs only free up at ``release_s`` — the incremental replan's view
    of jobs it decided not to preempt.
    """
    if isinstance(total_gpus, dict):
        free = dict(total_gpus)
    else:
        free = {None: int(total_gpus)}

    # (release time, gpus, pool) for everything currently holding GPUs
    running: List[Tuple[float, int, Optional[str]]] = []
    for dc, g, release_s in reserved:
        key = dc if dc in free else None
        free[key] -= int(g)
        running.append((float(release_s), int(g), key))

    ranked = _rank_jobs(jobs, choices, objective)
    t = 0.0
    out: List[Assignment] = []
    queue = list(ranked)
    while queue:
        progressed = True
        while progressed and queue:
            progressed = False
            for job in list(queue):
                fits = [c for c in choices[job.name]
                        if c.n_gpus <= free[_pool_of(c, free)]]
                if fits:
                    c = min(fits, key=lambda c: c.runtime_s)
                    a = Assignment(job.name, c.technique, c.n_gpus, t,
                                   c.runtime_s, device_class=c.device_class)
                    out.append(a)
                    running.append((a.end_s, c.n_gpus, _pool_of(c, free)))
                    free[_pool_of(c, free)] -= c.n_gpus
                    queue.remove(job)
                    progressed = True
        if not queue:
            break
        if not running:
            raise RuntimeError("greedy: no feasible choice fits cluster")
        running.sort(key=lambda x: x[0])
        t_end, g_rel, key = running.pop(0)
        t = t_end
        free[key] += g_rel
    makespan = max((a.end_s for a in out), default=0.0)
    return Solution(out, makespan, "greedy")


def _solve_time_indexed(jobs: List[Job],
                        choice_map: Dict[str, List[Choice]],
                        budgets: Dict[Optional[str], int],
                        ub: Solution, solver_name: str, *,
                        n_slots: int, time_limit_s: float,
                        mip_gap: float,
                        horizon: Optional[float] = None,
                        start_windows: Optional[Dict[str, float]] = None,
                        window_pad_s: float = 0.0,
                        reserved: Iterable[Tuple] = (),
                        m_upper: float = np.inf,
                        objective: str = "makespan") -> Solution:
    """The shared time-indexed MILP core behind ``solve_joint`` (one
    pooled budget under the ``None`` key), ``solve_joint_classes`` (one
    budget per device class) and ``solve_residual``.

    Assembly is vectorized: variables are described by flat arrays
    (job index, slot, duration, GPUs, pool) built once, and every
    constraint family — assignment, per-(pool, slot) capacity,
    per-job makespan — lands as one bulk COO block.

    ``start_windows`` restricts a job's start slots to
    ``center ± window_pad_s`` (seconds) — the coarse-to-fine refinement
    and the warm-started replan both ride on it; a job whose window
    admits no start falls back to the full range.  ``reserved`` entries
    ``(pool, gpus, until_s)`` shrink capacity rows for the slots they
    cover (running jobs the incremental replan keeps in place).
    ``m_upper`` bounds the makespan variable (a known-feasible
    incumbent's value) so HiGHS can early-exit on gap.

    Falls back to the upper bound ``ub`` on infeasibility/timeout.
    """
    if horizon is None:
        horizon = max(ub.makespan_s, 1e-6) * 1.05
    delta = horizon / n_slots
    pools = list(budgets.keys())
    pool_idx = {p: i for i, p in enumerate(pools)}
    n_jobs = len(jobs)

    # ---- variable layout: one flat array per attribute, then M last
    ji_ch, ci_ch, t_ch, dur_ch, g_ch, pool_ch = [], [], [], [], [], []
    for ji, j in enumerate(jobs):
        win = (start_windows or {}).get(j.name)
        for ci, c in enumerate(choice_map[j.name]):
            dur = max(1, math.ceil(c.runtime_s / delta - 1e-9))
            if dur > n_slots:
                continue
            tmax = n_slots - dur
            if win is not None:
                lo = max(0, int(math.floor((win - window_pad_s) / delta)))
                hi = min(tmax, int(math.ceil((win + window_pad_s) / delta)))
                ts = np.arange(lo, hi + 1) if lo <= hi \
                    else np.arange(tmax + 1)
            else:
                ts = np.arange(tmax + 1)
            ji_ch.append(np.full(ts.size, ji))
            ci_ch.append(np.full(ts.size, ci))
            t_ch.append(ts)
            dur_ch.append(np.full(ts.size, dur))
            g_ch.append(np.full(ts.size, c.n_gpus))
            pool_ch.append(np.full(ts.size, pool_idx[_pool_of(c, budgets)]))
    if not t_ch:
        return ub
    ji_all = np.concatenate(ji_ch)
    ci_all = np.concatenate(ci_ch)
    t_all = np.concatenate(t_ch)
    dur_all = np.concatenate(dur_ch)
    g_all = np.concatenate(g_ch).astype(np.float64)
    pool_all = np.concatenate(pool_ch)
    nx = ji_all.size
    end_all = (t_all + dur_all) * delta

    if (np.bincount(ji_all, minlength=n_jobs) == 0).any():
        return ub                 # some job's every choice outlasts horizon

    b = _MilpBuilder(nx)
    # (1) each job picks exactly one (choice, start)
    b.add_block(ji_all, np.arange(nx), np.ones(nx),
                np.ones(n_jobs), np.ones(n_jobs))
    # (2) capacity per (budget pool, slot), minus reservations
    cap_ub = np.repeat(np.array([float(budgets[p]) for p in pools]),
                       n_slots)
    for dc, g_res, until_s in reserved:
        p = pool_idx[dc if dc in budgets else None]
        k = n_slots if not math.isfinite(until_s) else \
            min(n_slots, max(0, int(math.ceil(until_s / delta - 1e-9))))
        cap_ub[p * n_slots:p * n_slots + k] -= float(g_res)
    np.maximum(cap_ub, 0.0, out=cap_ub)
    reps = dur_all
    occ_var = np.repeat(np.arange(nx), reps)    # var of each occupancy
    offs = np.repeat(np.cumsum(reps) - reps, reps)
    taus = np.repeat(t_all, reps) + (np.arange(int(reps.sum())) - offs)
    b.add_block(pool_all[occ_var] * n_slots + taus, occ_var,
                g_all[occ_var],
                np.full(len(pools) * n_slots, -np.inf), cap_ub)
    # (3) the continuous variable M + cost vector, per objective.  For
    # makespan M bounds per-job ends (sum end*x - M <= 0, exact under
    # the assignment equality, and a tighter relaxation than per-var);
    # for fair_share M bounds per-TENANT mean ends instead; the two sum
    # objectives need no M rows at all (cost rides on the binaries).
    cvec = np.zeros(b.nvar)
    if objective == "fair_share":
        tenants = sorted({getattr(j, "tenant", "default") for j in jobs})
        tix = {name: i for i, name in enumerate(tenants)}
        ten_of = np.array([tix[getattr(j, "tenant", "default")]
                           for j in jobs])
        n_ten = np.bincount(ten_of, minlength=len(tenants)) \
            .astype(np.float64)
        b.add_block(
            np.concatenate([ten_of[ji_all], np.arange(len(tenants))]),
            np.concatenate([np.arange(nx),
                            np.full(len(tenants), b.M_idx)]),
            np.concatenate([end_all / n_ten[ten_of[ji_all]],
                            -np.ones(len(tenants))]),
            np.full(len(tenants), -np.inf), np.zeros(len(tenants)))
        cvec[b.M_idx] = 1.0
        cvec[:nx] = (delta * 1e-4) * t_all
    else:
        b.add_block(np.concatenate([ji_all, np.arange(n_jobs)]),
                    np.concatenate([np.arange(nx),
                                    np.full(n_jobs, b.M_idx)]),
                    np.concatenate([end_all, -np.ones(n_jobs)]),
                    np.full(n_jobs, -np.inf), np.zeros(n_jobs))
        if objective == "makespan":
            cvec[b.M_idx] = 1.0
            cvec[:nx] = (delta * 1e-4) * t_all
        else:
            w_all = np.array([_weight(j) for j in jobs])[ji_all]
            if objective == "weighted_completion":
                cost = w_all * end_all
            elif objective == "tardiness":
                dl = np.array([_deadline(j) for j in jobs])
                cost = w_all * np.maximum(0.0, end_all - dl[ji_all])
            else:
                raise ValueError(f"unknown objective {objective!r}; "
                                 f"expected one of {OBJECTIVES}")
            cvec[:nx] = cost + (delta * 1e-4) * t_all
    res = b.solve(cvec, time_limit_s=time_limit_s, mip_gap=mip_gap,
                  m_upper=m_upper)
    if res is None:
        return ub
    xb = res.x[:nx]
    pick: Dict[int, int] = {}
    for vi in np.flatnonzero(xb > 0.5):
        ji = int(ji_all[vi])
        if ji not in pick or xb[vi] > xb[pick[ji]]:
            pick[ji] = int(vi)
    if len(pick) != n_jobs:
        return ub
    assignments = []
    for ji, j in enumerate(jobs):
        vi = pick[ji]
        c = choice_map[j.name][int(ci_all[vi])]
        assignments.append(Assignment(j.name, c.technique, c.n_gpus,
                                      float(t_all[vi]) * delta,
                                      c.runtime_s,
                                      device_class=c.device_class))
    makespan = max(a.end_s for a in assignments)
    sol = Solution(assignments, makespan, solver_name,
                   milp_status=res.message)
    # keep whichever plan is better UNDER THE OBJECTIVE (slot rounding
    # can make the MILP's integral plan worse than the greedy bound)
    if objective == "makespan":
        return sol if makespan <= ub.makespan_s + 1e-6 else ub
    sv = objective_value(sol.assignments, jobs, objective)
    uv = objective_value(ub.assignments, jobs, objective)
    return sol if sv <= uv + 1e-6 else ub


# below this estimated binary count the dense MILP is already cheap and
# exact — refinement would only risk quality for no wall-time win
_REFINE_MIN_BINARIES = 1000


def _solve_refined(jobs, choice_map, budgets, ub, solver_name, *,
                   n_slots, coarse_slots, time_limit_s, mip_gap,
                   objective="makespan", reserved=()):
    """Coarse-to-fine: solve on ``coarse_slots`` first, then on the full
    ``n_slots`` grid with each job's starts windowed one coarse slot
    around the incumbent's start — roughly a
    ``n_slots / coarse_slots``-fold binary-count cut.

    Small instances (estimated binaries below ``_REFINE_MIN_BINARIES``)
    skip the refinement and solve dense: they are fast anyway and the
    dense answer is exact."""
    est_binaries = sum(len(choice_map[j.name]) for j in jobs) * n_slots
    if n_slots <= coarse_slots or est_binaries < _REFINE_MIN_BINARIES:
        return _solve_time_indexed(
            jobs, choice_map, budgets, ub, solver_name, n_slots=n_slots,
            time_limit_s=time_limit_s, mip_gap=mip_gap,
            reserved=reserved, objective=objective)
    horizon = max(ub.makespan_s, 1e-6) * 1.05
    # budget split keeps the refined path's TOTAL wall under the dense
    # path's single time limit even when both stages hit their caps
    coarse = _solve_time_indexed(
        jobs, choice_map, budgets, ub, solver_name,
        n_slots=coarse_slots, time_limit_s=0.3 * time_limit_s,
        mip_gap=mip_gap, horizon=horizon, reserved=reserved,
        objective=objective)
    windows = {a.job: a.start_s for a in coarse.assignments}
    ub2 = coarse if objective_value(coarse.assignments, jobs, objective) \
        < objective_value(ub.assignments, jobs, objective) else ub
    return _solve_time_indexed(
        jobs, choice_map, budgets, ub2, solver_name, n_slots=n_slots,
        time_limit_s=0.7 * time_limit_s, mip_gap=mip_gap,
        horizon=horizon, start_windows=windows,
        window_pad_s=horizon / coarse_slots, reserved=reserved,
        objective=objective)


def solve_joint(jobs: List[Job],
                profiles: Dict[Tuple[str, str, int], Profile],
                total_gpus: int, *,
                n_slots: int = 24,
                time_limit_s: float = 30.0,
                mip_gap: float = 0.02,
                refine: bool = False,
                coarse_slots: int = 8,
                objective: str = "makespan",
                reserved: Iterable[Tuple] = ()) -> Solution:
    """The joint MILP.  Falls back to greedy on infeasibility/timeout.

    ``refine=True`` enables the coarse-to-fine pass (solve on
    ``coarse_slots``, re-solve on ``n_slots`` restricted to windows
    around the incumbent) — the fast path for large job counts.

    ``objective`` selects what the MILP minimizes (see ``OBJECTIVES``);
    the default reproduces the paper's makespan formulation.

    ``reserved`` pre-loads ``(class_or_None, gpus, release_s)`` capacity
    reservations the plan must schedule around — running jobs an
    incremental replan keeps, or serving-fleet allocations (see
    :func:`repro_torch.serving.fleet.fleet_reservations`).
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"expected one of {OBJECTIVES}")
    reserved = list(reserved)
    choice_map = pooled_choice_map(jobs, profiles)
    ub = greedy_schedule(jobs, choice_map, total_gpus,
                         reserved=reserved, objective=objective)
    budgets = {None: int(total_gpus)}
    if refine:
        return _solve_refined(jobs, choice_map, budgets, ub, "milp",
                              n_slots=n_slots, coarse_slots=coarse_slots,
                              time_limit_s=time_limit_s, mip_gap=mip_gap,
                              reserved=reserved, objective=objective)
    return _solve_time_indexed(jobs, choice_map, budgets,
                               ub, "milp", n_slots=n_slots,
                               time_limit_s=time_limit_s, mip_gap=mip_gap,
                               reserved=reserved, objective=objective)


def solve_joint_classes(jobs: List[Job], profiles, cluster, *,
                        n_slots: int = 20,
                        time_limit_s: float = 30.0,
                        mip_gap: float = 0.05,
                        refine: bool = False,
                        coarse_slots: int = 8,
                        objective: str = "makespan",
                        reserved: Iterable[Tuple] = ()) -> Solution:
    """Device-class-aware joint MILP for heterogeneous clusters.

    A job's config space is the union over device classes of its
    feasible (technique, g) choices ON that class — each evaluated
    against the class's own throughput curve, so a V100 choice carries a
    genuinely longer runtime than its A100 twin.  The flat capacity
    constraint becomes one capacity row per (class, slot): apportionment
    now picks *which* class as well as *how many* GPUs.  Assignments
    carry the chosen class, which the runtime's ClassPool placement pins.

    ``reserved`` pre-loads ``(class, gpus, release_s)`` reservations —
    running jobs kept by a replan, or serving-fleet holdings.

    Falls back to a per-class-budget greedy on infeasibility/timeout.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"expected one of {OBJECTIVES}")
    reserved = list(reserved)
    choice_map, budgets = class_choice_map(jobs, profiles,
                                           cluster.device_classes)
    ub = greedy_schedule(jobs, choice_map, budgets, reserved=reserved,
                         objective=objective)
    if refine:
        return _solve_refined(jobs, choice_map, budgets, ub,
                              "milp-classes", n_slots=n_slots,
                              coarse_slots=coarse_slots,
                              time_limit_s=time_limit_s, mip_gap=mip_gap,
                              reserved=reserved, objective=objective)
    return _solve_time_indexed(jobs, choice_map, budgets, ub,
                               "milp-classes", n_slots=n_slots,
                               time_limit_s=time_limit_s, mip_gap=mip_gap,
                               reserved=reserved, objective=objective)


def solve_joint_serving(jobs: List[Job], serves, profiles, cluster, *,
                        window_s: float, horizon_s: float,
                        util_cap: float = 0.7,
                        **solver_kw) -> Tuple[Solution, dict]:
    """The joint train+serve plan: size every serving fleet under its
    latency SLO first (device class + per-window replica counts from the
    measured throughput curves — :func:`repro_torch.serving.fleet.plan_fleets`),
    convert the fleets into capacity reservations, and solve the
    training MILP around them.

    Returns ``(solution, fleet_plans)``.  ``profiles`` must answer both
    training keys and ``(name, "serve", class, gpus)`` serve keys (see
    :func:`repro_torch.serving.fleet.serve_profiles` and
    :class:`repro_torch.core.perfmodel.MergedProfiles`).
    """
    from ..serving.fleet import fleet_reservations, plan_fleets
    plans = plan_fleets(serves, profiles, cluster, window_s=window_s,
                        horizon_s=horizon_s, util_cap=util_cap)
    reserved = fleet_reservations(plans)
    if cluster.hetero:
        sol = solve_joint_classes(jobs, profiles, cluster,
                                  reserved=reserved, **solver_kw)
    else:
        sol = solve_joint(jobs, profiles, cluster.total_gpus,
                          reserved=reserved, **solver_kw)
    return sol, plans


# --------------------------------------------- warm-started incremental

def split_fixed_running(jobs: List[Job], remaining: Dict[str, int],
                        current: Dict[str, Tuple], running,
                        choice_map: Dict[str, List[Choice]], profiles,
                        restart_cost_s: float
                        ) -> Tuple[List[Assignment], List[Job]]:
    """Partition live jobs for the incremental replan.

    A job that is RUNNING under assignment ``(tech, g[, class])`` is
    *fixed* — kept in place, modeled as a capacity reservation — when
    switching provably cannot pay off on current estimates:
    ``remaining_runtime(current) <= best_remaining_runtime +
    restart_cost_s``.  Everything else (waiting, restarting, and running
    jobs a better config might rescue) lands in the residual the MILP
    actually re-solves.
    """
    from .perfmodel import step_time_of
    fixed: List[Assignment] = []
    residual: List[Job] = []
    for j in jobs:
        asn = current.get(j.name)
        if j.name in running and asn:
            tech, g = asn[0], int(asn[1])
            dc = asn[2] if len(asn) > 2 else None
            rem = remaining.get(j.name, j.total_steps)
            try:
                st = step_time_of(profiles, j.name, tech, g,
                                  device_class=dc)
            except KeyError:
                st = float("inf")
            cur_rt = st * rem
            best_rt = min((c.runtime_s for c in choice_map[j.name]),
                          default=float("inf"))
            if math.isfinite(cur_rt) and \
                    cur_rt <= best_rt + restart_cost_s:
                fixed.append(Assignment(j.name, tech, g, 0.0, cur_rt,
                                        device_class=dc))
                continue
        residual.append(j)
    return fixed, residual


def solve_residual(residual_jobs: List[Job],
                   choice_map: Dict[str, List[Choice]],
                   budgets: Dict[Optional[str], int],
                   fixed: List[Assignment], *,
                   n_slots: int = 24,
                   time_limit_s: float = 10.0,
                   mip_gap: float = 0.05,
                   warm_starts: Optional[Dict[str, float]] = None,
                   objective: str = "makespan") -> Solution:
    """Warm-started incremental replan: solve only the residual jobs.

    ``fixed`` assignments (running jobs not worth preempting) become
    per-pool capacity reservations until their estimated ends instead of
    MILP variables; ``warm_starts`` (job -> previous planned start, in
    seconds from now) windows each residual job's start variables around
    the previous solution.  The reservation-aware greedy bound both
    sizes the horizon and is installed as an upper bound on the makespan
    variable, so the solve early-exits once within gap of it.

    Returns the merged Solution: fixed assignments (start 0) plus the
    residual plan.
    """
    fixed = list(fixed)
    if not residual_jobs:
        mk = max((a.end_s for a in fixed), default=0.0)
        return Solution(fixed, mk, "fixed")
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"expected one of {OBJECTIVES}")
    reserved = [(a.device_class, a.n_gpus, a.runtime_s) for a in fixed]
    ub = greedy_schedule(residual_jobs, choice_map, budgets,
                         reserved=reserved, objective=objective)
    horizon = max([ub.makespan_s] + [a.end_s for a in fixed]
                  + [1e-6]) * 1.05
    delta = horizon / n_slots
    # provably safe incumbent bound: any schedule at least as good as
    # the greedy ub stays slot-representable within one slot per job
    # in a delay chain (+ one per reservation release it waits on).
    # Only valid when M IS the makespan — the other objectives leave M
    # unbounded (fair_share's M tracks tenant means, not the horizon).
    m_upper = min(horizon, ub.makespan_s
                  + delta * (len(residual_jobs) + len(fixed))) \
        if objective == "makespan" else np.inf
    sol = _solve_time_indexed(
        residual_jobs, choice_map, budgets, ub, "milp-incremental",
        n_slots=n_slots, time_limit_s=time_limit_s, mip_gap=mip_gap,
        horizon=horizon, start_windows=warm_starts,
        window_pad_s=horizon / 8.0, reserved=reserved, m_upper=m_upper,
        objective=objective)
    assignments = fixed + list(sol.assignments)
    mk = max(a.end_s for a in assignments)
    name = sol.solver if sol.solver.startswith("milp") \
        else "greedy-incremental"
    return Solution(assignments, mk, name, milp_status=sol.milp_status)


# ------------------------------------------------------ node-aware MILP

def solve_joint_nodes(jobs: List[Job],
                      profiles: Dict[Tuple[str, str, int], Profile],
                      nodes: int, gpus_per_node: int, *,
                      n_slots: int = 16,
                      time_limit_s: float = 30.0,
                      mip_gap: float = 0.05) -> Solution:
    """Node-locality-aware joint MILP.

    Single-node configs (g <= gpus_per_node) additionally choose a node;
    larger configs must be whole-node multiples (you allocate whole
    p4d/ICI-slice nodes) and pick which nodes via binaries y[j,c,t,nu].
    Per-(node, slot) capacity replaces the flat pool constraint, so two
    5-GPU jobs can NOT share a single 8-GPU node with a third.  The
    solution's assignments carry the chosen node sets, which the
    runtime's NodeAware placement backend uses as placement hints.
    """
    G = nodes * gpus_per_node
    choice_map = {j.name: choices_from_profiles(j, profiles) for j in jobs}
    for j in jobs:
        kept = []
        for c in choice_map[j.name]:
            if c.n_gpus <= gpus_per_node or c.n_gpus % gpus_per_node == 0:
                kept.append(c)
        choice_map[j.name] = kept
        if not kept:
            raise ValueError(f"job {j.name}: no node-feasible choice")
    ub = greedy_schedule(jobs, choice_map, G)  # node-UNaware (optimistic)
    seq_total = sum(min(c.runtime_s for c in choice_map[j.name])
                    for j in jobs)  # sequential = always node-feasible
    return _solve_nodes_at_horizon(
        jobs, choice_map, ub, nodes, gpus_per_node,
        horizons=[max(ub.makespan_s, 1e-6) * 1.3, seq_total * 1.05],
        n_slots=n_slots, time_limit_s=time_limit_s, mip_gap=mip_gap)


def _solve_nodes_at_horizon(jobs, choice_map, ub, nodes, gpus_per_node, *,
                            horizons, n_slots, time_limit_s, mip_gap):
    best = None
    for horizon in horizons:
        sol = _solve_nodes_once(jobs, choice_map, nodes, gpus_per_node,
                                horizon=horizon, n_slots=n_slots,
                                time_limit_s=time_limit_s, mip_gap=mip_gap)
        if sol is not None and (best is None
                                or sol.makespan_s < best.makespan_s):
            best = sol
        if best is not None:
            break  # first feasible horizon wins (tighter delta)
    return best if best is not None else ub


# variable kinds in the node MILP's flat arrays
_X1, _XM, _Y = 0, 1, 2


def _solve_nodes_once(jobs, choice_map, nodes, gpus_per_node, *,
                      horizon, n_slots, time_limit_s, mip_gap):
    """One node-MILP solve at a fixed horizon, vectorized like
    ``_solve_time_indexed``: variables are x1[j,c,t,nu] (single-node
    configs pick a node), xm[j,c,t] + y[j,c,t,nu] (whole-node configs
    pick a node SET), all described by flat attribute arrays, with each
    constraint family emitted as one bulk COO block."""
    delta = horizon / n_slots

    kind_ch, ji_ch, ci_ch, t_ch, nu_ch = [], [], [], [], []
    dur_ch, g_ch, parent_ch = [], [], []
    nvar = 0
    for ji, j in enumerate(jobs):
        for ci, c in enumerate(choice_map[j.name]):
            dur = max(1, math.ceil(c.runtime_s / delta - 1e-9))
            if dur > n_slots:
                continue
            nst = n_slots - dur + 1
            if c.n_gpus <= gpus_per_node:
                n = nst * nodes
                kind_ch.append(np.full(n, _X1))
                t_ch.append(np.repeat(np.arange(nst), nodes))
                nu_ch.append(np.tile(np.arange(nodes), nst))
                parent_ch.append(np.full(n, -1))
            else:
                # per start slot: one xm var then its `nodes` y vars
                n = nst * (1 + nodes)
                kinds = np.full(n, _Y)
                kinds[::1 + nodes] = _XM
                kind_ch.append(kinds)
                t_ch.append(np.repeat(np.arange(nst), 1 + nodes))
                nus = np.tile(np.arange(-1, nodes), nst)
                nu_ch.append(nus)
                xm_pos = nvar + np.arange(0, n, 1 + nodes)
                parents = np.repeat(xm_pos, 1 + nodes)
                parents[::1 + nodes] = -1     # xm vars have no parent
                parent_ch.append(parents)
            ji_ch.append(np.full(n, ji))
            ci_ch.append(np.full(n, ci))
            dur_ch.append(np.full(n, dur))
            g_ch.append(np.full(n, c.n_gpus))
            nvar += n
    if not t_ch:
        return None
    kind_all = np.concatenate(kind_ch)
    ji_all = np.concatenate(ji_ch)
    ci_all = np.concatenate(ci_ch)
    t_all = np.concatenate(t_ch)
    nu_all = np.concatenate(nu_ch)
    dur_all = np.concatenate(dur_ch)
    g_all = np.concatenate(g_ch)
    parent_all = np.concatenate(parent_ch)
    nx = kind_all.size
    starts = kind_all != _Y                   # x1 and xm: "start" vars
    n_jobs = len(jobs)
    if (np.bincount(ji_all[starts], minlength=n_jobs) == 0).any():
        return None

    b = _MilpBuilder(nx)
    # (1) one (choice, start[, node-set]) per job
    sv = np.flatnonzero(starts)
    b.add_block(ji_all[sv], sv, np.ones(sv.size),
                np.ones(n_jobs), np.ones(n_jobs))
    # (2) whole-node jobs: sum_nu y - k * xm == 0, one row per xm var
    xm_vars = np.flatnonzero(kind_all == _XM)
    if xm_vars.size:
        xm_row = np.full(nx, -1)
        xm_row[xm_vars] = np.arange(xm_vars.size)
        y_vars = np.flatnonzero(kind_all == _Y)
        k_of = g_all[xm_vars] // gpus_per_node
        b.add_block(
            np.concatenate([np.arange(xm_vars.size),
                            xm_row[parent_all[y_vars]]]),
            np.concatenate([xm_vars, y_vars]),
            np.concatenate([-k_of.astype(np.float64),
                            np.ones(y_vars.size)]),
            np.zeros(xm_vars.size), np.zeros(xm_vars.size))
    # (3) per-(node, slot) capacity: x1 vars weigh their GPU count, y
    # vars a whole node; expand each var over its occupied slots
    occ = np.flatnonzero(kind_all != _XM)
    reps = dur_all[occ]
    occ_var = np.repeat(occ, reps)
    offs = np.repeat(np.cumsum(reps) - reps, reps)
    taus = np.repeat(t_all[occ], reps) + (np.arange(int(reps.sum())) - offs)
    weights = np.where(kind_all[occ_var] == _X1,
                       g_all[occ_var], gpus_per_node).astype(np.float64)
    b.add_block(nu_all[occ_var] * n_slots + taus, occ_var, weights,
                np.full(nodes * n_slots, -np.inf),
                np.full(nodes * n_slots, float(gpus_per_node)))
    # (4) makespan, aggregated per job over its start vars
    end_all = (t_all + dur_all) * delta
    b.add_block(np.concatenate([ji_all[sv], np.arange(n_jobs)]),
                np.concatenate([sv, np.full(n_jobs, b.M_idx)]),
                np.concatenate([end_all[sv], -np.ones(n_jobs)]),
                np.full(n_jobs, -np.inf), np.zeros(n_jobs))

    cvec = np.zeros(b.nvar)
    cvec[b.M_idx] = 1.0
    cvec[sv] = (delta * 1e-4) * t_all[sv]
    res = b.solve(cvec, time_limit_s=time_limit_s, mip_gap=mip_gap)
    if res is None:
        return None
    xb = res.x[:nx]
    pick: Dict[int, int] = {}
    for vi in np.flatnonzero((xb > 0.5) & starts):
        ji = int(ji_all[vi])
        if ji not in pick or xb[vi] > xb[pick[ji]]:
            pick[ji] = int(vi)
    if len(pick) != n_jobs:
        return None
    assignments = []
    for ji, j in enumerate(jobs):
        vi = pick[ji]
        c = choice_map[j.name][int(ci_all[vi])]
        if kind_all[vi] == _X1:
            node_set: Tuple[int, ...] = (int(nu_all[vi]),)
        else:
            ys = np.flatnonzero((parent_all == vi) & (xb > 0.5))
            node_set = tuple(sorted(int(nu_all[y]) for y in ys))
        assignments.append(Assignment(j.name, c.technique, c.n_gpus,
                                      float(t_all[vi]) * delta,
                                      c.runtime_s, nodes=node_set))
    makespan = max(a.end_s for a in assignments)
    return Solution(assignments, makespan, "milp-nodes",
                    milp_status=res.message)
