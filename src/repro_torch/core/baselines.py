"""The paper's four baselines (§3) plus the SATURN policy itself.

- Current Practice: all GPUs of a node to one job, jobs in sequence,
  task parallelism across nodes.
- Random: random parallelism, allocation and order (seeded).
- Optimus (Peng et al., EuroSys'18): greedy marginal-gain GPU allocation.
- Optimus-Dynamic: Optimus + the introspection mechanism.
- Saturn: the joint MILP (+ introspection); under a node-aware cluster
  (``ClusterSpec(placement="node")``) it runs the node-locality MILP
  and emits node placement hints the runtime honors; on a heterogeneous
  cluster (multiple :class:`~repro_torch.core.job.DeviceClass`) it runs the
  class-aware MILP and pins each job to a device class.

All policies emit Schedule IR (:class:`repro_torch.core.schedule.Schedule`)
and are device-class aware: on heterogeneous clusters their entries are
class-qualified, on legacy single-class clusters they reduce exactly to
the historical behavior.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np

from .perfmodel import iter_job_class_profiles, iter_job_profiles
from .portfolio import solve_portfolio
from .schedule import Policy, Schedule, ScheduleEntry
from .solver import (OBJECTIVES, Assignment, Solution, class_choice_map,
                     pooled_choice_map, solve_joint, solve_joint_classes,
                     solve_joint_nodes, solve_residual,
                     split_fixed_running)


def _is_hetero(cluster) -> bool:
    return getattr(cluster, "hetero", False)


def _feasible(job, profiles, device_class=None):
    """Feasible (technique, g, step_time) triples for one job on one
    device class — from the legacy dict or a PerfModel's curves."""
    return [(tech, g, p.step_time_s)
            for tech, g, p in iter_job_profiles(profiles, job.name,
                                                device_class=device_class)
            if p.feasible]


def _feasible_classes(job, profiles):
    """Feasible (technique, device_class, g, step_time) across every
    class the profiles cover."""
    return [(tech, dc, g, p.step_time_s)
            for tech, dc, g, p in iter_job_class_profiles(profiles,
                                                          job.name)
            if p.feasible]


def _best_at_count(job, profiles, g, device_class=None):
    cands = [(tech, p.step_time_s)
             for tech, gg, p in iter_job_profiles(profiles, job.name,
                                                  device_class=device_class)
             if gg == g and p.feasible]
    if not cands:
        return None
    return min(cands, key=lambda x: x[1])


def _cluster_nodes(cluster) -> List[Tuple]:
    """Every (device_class, gpus_per_node) node in the cluster, in
    declaration order — what "one job per node" task parallelism
    round-robins over."""
    out = []
    for dc in cluster.device_classes:
        out.extend([(dc.name, dc.gpus_per_node)] * dc.nodes)
    return out


class CurrentPractice(Policy):
    """Typical current practice (paper §3): every job gets a full node
    and runs under the standard go-to setup — FSDP — one job per node at
    a time, task-parallel across nodes.  (No per-job tuning: that is
    exactly what Saturn automates.)  On a mixed fleet, jobs take whole
    nodes round-robin across ALL nodes regardless of generation — the
    class-blind behavior Saturn's class-aware planning beats."""

    name = "current-practice"
    dynamic = False
    default_technique = "fsdp"

    def _entry_for(self, j, profiles, g, dclass):
        """Full-node entry on one class: default technique if feasible
        there, else the best feasible technique at that count."""
        cands = {tech: p.step_time_s
                 for tech, gg, p in iter_job_profiles(profiles, j.name,
                                                      device_class=dclass)
                 if gg == g and p.feasible}
        if cands:
            tech = self.default_technique if self.default_technique \
                in cands else min(cands, key=cands.get)
            return ScheduleEntry(j.name, tech, g, device_class=dclass)
        # fall back to any feasible config on this class
        feas = _feasible(j, profiles, device_class=dclass)
        if not feas:
            return None
        tech, g, _ = min(feas, key=lambda x: x[2])
        return ScheduleEntry(j.name, tech, g, device_class=dclass)

    def plan(self, jobs, remaining, profiles, cluster, current):
        if _is_hetero(cluster):
            nodes = _cluster_nodes(cluster)
            entries = []
            for i, j in enumerate(jobs):
                dclass, g = nodes[i % len(nodes)]
                e = self._entry_for(j, profiles, g, dclass)
                if e is None:  # does not fit this node class: any class
                    feas = _feasible_classes(j, profiles)
                    if not feas:
                        raise ValueError(f"{j.name}: infeasible everywhere")
                    tech, dc, g, _ = min(feas, key=lambda x: x[3])
                    e = ScheduleEntry(j.name, tech, g, device_class=dc)
                entries.append(e)
            return Schedule(entries, solver=self.name)
        entries = []
        for j in jobs:
            g = cluster.gpus_per_node
            if (j.name, self.default_technique, g) in profiles and \
                    profiles[(j.name, self.default_technique, g)].feasible:
                tech = self.default_technique
            else:
                best = _best_at_count(j, profiles, g)
                if best is None:  # fall back to any feasible
                    feas = _feasible(j, profiles)
                    if not feas:
                        raise ValueError(f"{j.name}: infeasible everywhere")
                    tech, g, _ = min(feas, key=lambda x: x[2])
                else:
                    tech = best[0]
            entries.append(ScheduleEntry(j.name, tech, g))
        return Schedule(entries, solver=self.name)


class CurrentPracticeTuned(CurrentPractice):
    """Ablation: current practice but with the per-job BEST technique at
    full-node allocation (isolates Saturn's packing/allocation gains
    from its parallelism-selection gains)."""

    name = "current-practice-tuned"
    # the per-job best technique: never prefer the go-to default
    default_technique = ""

    def plan(self, jobs, remaining, profiles, cluster, current):
        if _is_hetero(cluster):
            return super().plan(jobs, remaining, profiles, cluster,
                                current)
        entries = []
        for j in jobs:
            g = cluster.gpus_per_node
            best = _best_at_count(j, profiles, g)
            if best is None:
                feas = _feasible(j, profiles)
                if not feas:
                    raise ValueError(f"{j.name}: infeasible everywhere")
                tech, g, _ = min(feas, key=lambda x: x[2])
            else:
                tech = best[0]
            entries.append(ScheduleEntry(j.name, tech, g))
        return Schedule(entries, solver=self.name)


class RandomPolicy(Policy):
    name = "random"
    dynamic = False

    def __init__(self, seed: int = 0):
        self.seed = seed

    def plan(self, jobs, remaining, profiles, cluster, current):
        rng = np.random.RandomState(self.seed)
        if _is_hetero(cluster):
            entries = []
            for j in jobs:
                feas = _feasible_classes(j, profiles)
                tech, dc, g, _ = feas[rng.randint(len(feas))]
                entries.append(ScheduleEntry(j.name, tech, g,
                                             device_class=dc))
            rng.shuffle(entries)
            return Schedule(entries, solver=self.name)
        order = []
        for j in jobs:
            feas = _feasible(j, profiles)
            tech, g, _ = feas[rng.randint(len(feas))]
            order.append((j.name, tech, g))
        rng.shuffle(order)
        return Schedule.from_tuples(order, solver=self.name)


class Optimus(Policy):
    """Greedy marginal-gain allocation: every job starts at its smallest
    feasible GPU count; remaining GPUs go one-at-a-time to the job with
    the largest estimated marginal runtime reduction.

    On a heterogeneous cluster the allocation key is (device_class, g)
    and each class has its own GPU budget: jobs start on their cheapest
    feasible start, and the marginal-gain loop may grow a job within its
    class OR move it to a strictly faster budget-feasible config on
    another class — so both pools get spent.  (Migrating an already
    RUNNING job across classes remains Saturn's introspection edge.)
    """

    name = "optimus"
    dynamic = False

    def plan(self, jobs, remaining, profiles, cluster, current):
        if _is_hetero(cluster):
            return self._plan_hetero(jobs, remaining, profiles, cluster)
        live = [j for j in jobs if remaining.get(j.name, 0) > 0]
        runtime_at: Dict[str, Dict[int, Tuple[str, float]]] = {}
        for j in live:
            per_g: Dict[int, Tuple[str, float]] = {}
            for tech, g, p in iter_job_profiles(profiles, j.name):
                if not p.feasible:
                    continue
                t = p.step_time_s * remaining[j.name]
                if g not in per_g or t < per_g[g][1]:
                    per_g[g] = (tech, t)
            runtime_at[j.name] = per_g
        alloc: Dict[str, int] = {}
        budget = cluster.total_gpus
        # min feasible first (paper: one GPU at a time, from zero)
        for j in sorted(live, key=lambda j: -remaining.get(j.name, 0)):
            gmin = min(runtime_at[j.name]) if runtime_at[j.name] else None
            if gmin is not None and gmin <= budget:
                alloc[j.name] = gmin
                budget -= gmin
        # marginal gains
        improved = True
        while budget > 0 and improved:
            improved = False
            best_gain, best_job, best_g = 0.0, None, None
            for jname, g in alloc.items():
                per_g = runtime_at[jname]
                uppers = [gg for gg in per_g if gg > g and gg - g <= budget]
                if not uppers:
                    continue
                g2 = min(uppers)
                gain = (per_g[g][1] - per_g[g2][1]) / max(g2 - g, 1)
                if gain > best_gain:
                    best_gain, best_job, best_g = gain, jname, g2
            if best_job is not None:
                budget -= best_g - alloc[best_job]
                alloc[best_job] = best_g
                improved = True
        order = []
        for j in live:
            if j.name in alloc:
                g = alloc[j.name]
                order.append((j.name, runtime_at[j.name][g][0], g))
        # unallocated jobs queue behind with their min feasible config
        for j in live:
            if j.name not in alloc and runtime_at[j.name]:
                gmin = min(runtime_at[j.name])
                order.append((j.name, runtime_at[j.name][gmin][0], gmin))
        return Schedule.from_tuples(order, solver=self.name)

    def _plan_hetero(self, jobs, remaining, profiles, cluster):
        live = [j for j in jobs if remaining.get(j.name, 0) > 0]
        # runtime_at[job][(class, g)] = (technique, est total runtime)
        runtime_at: Dict[str, Dict[Tuple[str, int], Tuple[str, float]]] = {}
        for j in live:
            per_cg: Dict[Tuple[str, int], Tuple[str, float]] = {}
            for tech, dc, g, p in iter_job_class_profiles(profiles, j.name):
                if not p.feasible:
                    continue
                t = p.step_time_s * remaining[j.name]
                key = (dc, g)
                if key not in per_cg or t < per_cg[key][1]:
                    per_cg[key] = (tech, t)
            runtime_at[j.name] = per_cg
        budgets = {dc.name: dc.total_gpus for dc in cluster.device_classes}
        alloc: Dict[str, Tuple[str, int]] = {}
        for j in sorted(live, key=lambda j: -remaining.get(j.name, 0)):
            # cheapest feasible start: fewest GPUs, fastest class on ties
            starts = sorted(runtime_at[j.name],
                            key=lambda cg: (cg[1],
                                            runtime_at[j.name][cg][1]))
            for dc, g in starts:
                if g <= budgets[dc]:
                    alloc[j.name] = (dc, g)
                    budgets[dc] -= g
                    break
        improved = True
        while improved:
            improved = False
            best_gain, best_job, best_key = 0.0, None, None
            for jname, (dc, g) in alloc.items():
                per_cg = runtime_at[jname]
                cur_rt = per_cg[(dc, g)][1]
                for (dc2, g2), (_, rt2) in per_cg.items():
                    if rt2 >= cur_rt - 1e-12:
                        continue      # only strictly faster configs
                    back = g if dc2 == dc else 0   # GPUs given back
                    if g2 > budgets[dc2] + back:
                        continue
                    gain = (cur_rt - rt2) / max(g2 - back, 1)
                    if gain > best_gain:
                        best_gain, best_job = gain, jname
                        best_key = (dc2, g2)
            if best_job is not None:
                dc, g = alloc[best_job]
                dc2, g2 = best_key
                budgets[dc] += g
                budgets[dc2] -= g2
                alloc[best_job] = best_key
                improved = True
        entries = []
        for j in live:
            if j.name in alloc:
                dc, g = alloc[j.name]
                entries.append(ScheduleEntry(
                    j.name, runtime_at[j.name][(dc, g)][0], g,
                    device_class=dc))
        for j in live:  # unallocated: queue behind on cheapest start
            if j.name not in alloc and runtime_at[j.name]:
                dc, g = min(runtime_at[j.name],
                            key=lambda cg: (cg[1],
                                            runtime_at[j.name][cg][1]))
                entries.append(ScheduleEntry(
                    j.name, runtime_at[j.name][(dc, g)][0], g,
                    device_class=dc))
        return Schedule(entries, solver=self.name)


class OptimusDynamic(Optimus):
    name = "optimus-dynamic"
    dynamic = True


class SaturnPolicy(Policy):
    """The joint MILP; with ``dynamic`` the runtime re-invokes it at
    introspection intervals / arrivals on observed remaining work.

    On a node-aware cluster (``cluster.placement == "node"``) the plan
    comes from ``solve_joint_nodes`` and carries node assignments; on a
    heterogeneous cluster it comes from ``solve_joint_classes`` and
    pins each job to a device class — so an introspection replan may
    migrate a job across classes, paying the real restart penalty.

    ``refine`` enables the solver's coarse-to-fine slot refinement;
    ``incremental`` (default) makes replans warm-started: running jobs
    whose current config cannot profitably be switched (best remaining
    runtime + restart cost is no better) are fixed as capacity
    reservations, the previous plan's start times window the residual
    MILP, and only the residual (waiting jobs + remaining work) is
    re-solved.  The node-aware MILP has no incremental path and replans
    from scratch.

    ``objective`` picks what the MILP minimizes (``OBJECTIVES`` in
    :mod:`repro_torch.core.solver`): the paper's makespan (default), weighted
    completion time, deadline tardiness, or per-tenant fair share.  The
    node-aware MILP supports only makespan.

    ``solver="portfolio"`` races the MILP against the interval-time LNS
    (:mod:`repro_torch.core.portfolio`) under ``time_limit_s`` of shared wall
    budget with ``mip_gap`` as the first-to-gap target — the setting for
    large job counts (64+) where the dense MILP caps out.  Replans reuse
    the warm start both ways: previous starts window the MILP and seed
    the LNS incumbent.  Not available under node-aware placement (the
    node MILP has no portfolio peer).

    Every plan carries ``Schedule.telemetry`` — ``{backend, wall_s, gap,
    status, n_jobs}`` — which the runtime collects per (re)plan into
    ``SimResult.stats["solver"]``.
    """

    name = "saturn"
    dynamic = True
    replan_on_completion = False  # paper: re-solve on fixed intervals

    def __init__(self, n_slots: int = 24, time_limit_s: float = 10.0, *,
                 mip_gap: float = 0.05, refine: bool = False,
                 incremental: bool = True, objective: str = "makespan",
                 solver: str = "milp", seed: int = 0):
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"expected one of {OBJECTIVES}")
        if solver not in ("milp", "portfolio"):
            raise ValueError(f"unknown solver {solver!r}; "
                             "expected 'milp' or 'portfolio'")
        self.n_slots = n_slots
        self.time_limit_s = time_limit_s
        self.mip_gap = mip_gap
        self.refine = refine
        self.incremental = incremental
        self.objective = objective
        self.solver = solver
        self.seed = seed
        self._last_plan_t = 0.0

    @staticmethod
    def _live(jobs, remaining, now_s: float = 0.0):
        """Remaining-work copies of unfinished jobs.  The solver plans
        from t=0 = "now", so absolute deadlines shift by ``now_s`` (a
        deadline already blown clamps to 0: all further delay is
        tardiness)."""
        out = []
        for j in jobs:
            rem = remaining.get(j.name, j.total_steps)
            if rem <= 0:
                continue
            dl = getattr(j, "deadline_s", None)
            if dl is not None and now_s:
                dl = max(0.0, dl - now_s)
            out.append(dataclasses.replace(j, total_steps=rem,
                                           deadline_s=dl))
        return out

    def _choice_map(self, live, profiles, cluster):
        """Per-job choice lists, class-qualified on heterogeneous
        clusters — the SAME builders the full solvers use, so the
        incremental replan optimizes over an identical space."""
        if _is_hetero(cluster):
            return class_choice_map(live, profiles,
                                    cluster.device_classes)
        return (pooled_choice_map(live, profiles),
                {None: int(cluster.total_gpus)})

    @staticmethod
    def _emit(sol, n_jobs: int, t0: float) -> Schedule:
        """Solution -> Schedule, guaranteeing telemetry: backends that
        measured themselves (portfolio/LNS) pass theirs through;
        plain-MILP solves get it synthesized here."""
        sched = sol.to_schedule()
        if sched.telemetry is None:
            sched.telemetry = {"backend": sol.solver,
                               "wall_s": time.perf_counter() - t0,
                               "gap": None,
                               "status": sol.milp_status or sol.solver,
                               "n_jobs": n_jobs}
        return sched

    def plan(self, jobs, remaining, profiles, cluster, current,
             now_s: float = 0.0):
        t0 = time.perf_counter()
        live = self._live(jobs, remaining, now_s)
        if not live:
            return Schedule([], solver=self.name)
        if self.solver == "portfolio":
            if getattr(cluster, "placement", "flat") == "node":
                raise ValueError("solver='portfolio' does not support "
                                 "node-aware placement; use the node "
                                 "MILP (solver='milp')")
            choice_map, budgets = self._choice_map(live, profiles,
                                                   cluster)
            sol = solve_portfolio(
                live, choice_map, budgets, objective=self.objective,
                wall_budget_s=self.time_limit_s,
                gap_target=self.mip_gap, seed=self.seed)
            return self._emit(sol, len(live), t0)
        if _is_hetero(cluster):
            sol = solve_joint_classes(
                live, profiles, cluster, n_slots=min(self.n_slots, 20),
                time_limit_s=self.time_limit_s, mip_gap=self.mip_gap,
                refine=self.refine, objective=self.objective)
        elif getattr(cluster, "placement", "flat") == "node":
            if self.objective != "makespan":
                raise ValueError(
                    "the node-aware MILP supports only the makespan "
                    f"objective (got {self.objective!r})")
            sol = solve_joint_nodes(
                live, profiles, cluster.nodes, cluster.gpus_per_node,
                n_slots=min(self.n_slots, 16),
                time_limit_s=self.time_limit_s, mip_gap=self.mip_gap)
        else:
            sol = solve_joint(live, profiles, cluster.total_gpus,
                              n_slots=self.n_slots,
                              time_limit_s=self.time_limit_s,
                              mip_gap=self.mip_gap, refine=self.refine,
                              objective=self.objective)
        return self._emit(sol, len(live), t0)

    def plan_incremental(self, jobs, remaining, profiles, cluster,
                         current, *, prev=None, now_s=0.0,
                         running=frozenset()):
        if now_s < self._last_plan_t:
            # clock went backwards: the policy instance is being reused
            # for a fresh simulation — stale plan times must not shift
            # (or fail to shift) this run's warm windows
            self._last_plan_t = now_s
        elapsed = now_s - self._last_plan_t
        self._last_plan_t = now_s
        if not self.incremental or not running or prev is None \
                or not len(prev) \
                or getattr(cluster, "placement", "flat") == "node":
            # ``now_s`` (for deadline shifting) is SaturnPolicy.plan's
            # extension; subclasses overriding ``plan`` keep the base
            # Policy signature and manage their own world view
            if type(self).plan is SaturnPolicy.plan:
                return self.plan(jobs, remaining, profiles, cluster,
                                 current, now_s=now_s)
            return self.plan(jobs, remaining, profiles, cluster, current)
        t0 = time.perf_counter()
        live = self._live(jobs, remaining, now_s)
        if not live:
            return Schedule([], solver=self.name)
        choice_map, budgets = self._choice_map(live, profiles, cluster)
        fixed, residual = split_fixed_running(
            live, remaining, current, running, choice_map, profiles,
            cluster.restart_cost_s)
        if not residual:
            # every running job keeps its config; nothing to re-solve
            sol = solve_residual([], choice_map, budgets, fixed,
                                 objective=self.objective)
            return self._emit(sol, 0, t0)
        # warm incumbent: the previous plan's starts, shifted to now
        residual_names = {j.name for j in residual}
        warm = {e.job: max(0.0, e.start_s - elapsed)
                for e in prev.entries
                if e.start_s is not None and e.job in residual_names}
        if self.solver == "portfolio":
            sol = self._portfolio_residual(residual, choice_map,
                                           budgets, fixed, prev,
                                           elapsed, warm)
            return self._emit(sol, len(residual), t0)
        n_slots = min(self.n_slots, 20) if _is_hetero(cluster) \
            else self.n_slots
        sol = solve_residual(
            residual, choice_map, budgets, fixed, n_slots=n_slots,
            time_limit_s=self.time_limit_s, mip_gap=self.mip_gap,
            warm_starts=warm or None, objective=self.objective)
        return self._emit(sol, len(residual), t0)

    def _portfolio_residual(self, residual, choice_map, budgets, fixed,
                            prev, elapsed, warm):
        """The portfolio's incremental replan: fixed running jobs become
        ``reserved=`` capacity triples (exactly like ``solve_residual``),
        previous-plan starts window the MILP (``warm_starts``) AND seed
        the LNS incumbent (previous entries re-expressed as Assignments
        with remaining-work runtimes, shifted to now)."""
        reserved = [(a.device_class, a.n_gpus, a.runtime_s)
                    for a in fixed]
        residual_names = {j.name for j in residual}
        incumbent = []
        for e in prev.entries:
            if e.job not in residual_names or e.start_s is None:
                continue
            for c in choice_map[e.job]:
                if (c.technique == e.technique
                        and c.n_gpus == e.n_gpus
                        and c.device_class == e.device_class):
                    incumbent.append(Assignment(
                        e.job, c.technique, c.n_gpus,
                        max(0.0, e.start_s - elapsed), c.runtime_s,
                        device_class=c.device_class))
                    break
        sol = solve_portfolio(
            residual, choice_map, budgets, reserved=reserved,
            objective=self.objective, wall_budget_s=self.time_limit_s,
            gap_target=self.mip_gap, seed=self.seed,
            warm_starts=warm or None, incumbent=incumbent or None)
        assignments = list(fixed) + list(sol.assignments)
        mk = max(a.end_s for a in assignments)
        return Solution(assignments, mk, sol.solver,
                        milp_status=sol.milp_status,
                        telemetry=sol.telemetry)


class SaturnStatic(SaturnPolicy):
    """Ablation: the MILP without introspection."""
    name = "saturn-static"
    dynamic = False


def static_partition_fleets(serves, cluster, *, window_s: float = 60.0,
                            horizon_s=None, util_cap: float = 0.7):
    """The serving-side current practice: a peak-provisioned GPU
    partition per service, held for the whole run.  Returns a
    non-adaptive :class:`~repro_torch.serving.fleet.FleetManager` — every
    fleet is sized for its trace's WORST window and never scales down,
    so training only ever sees the leftover capacity.  The contrast
    baseline for Saturn's adaptive fleets, which return off-peak GPUs
    to the sweep and evict training again when bursts land."""
    from ..serving.fleet import FleetManager
    return FleetManager(serves, cluster, window_s=window_s,
                        horizon_s=horizon_s, util_cap=util_cap,
                        adaptive=False)
