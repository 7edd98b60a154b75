"""The port's scheduling core (src/repro_torch/core) against the JAX
package's, on the CPU.

The modules are numpy and scipy copies, so wherever no wall clock
decides the answer they must agree bit for bit:
- ``simulate`` under CurrentPractice, Optimus and OptimusDynamic, on
  flat placement with and without a seeded ChaosTrace of node failures
  and on node placement (which is not elastic: both packages refuse a
  trace there): the same makespan, Gantt entries, replans, restarts and
  failures.  The workloads are benchmarks/run.py's own
  (``_synthetic_runtime_workload`` and ``_chaos_workload``), carried
  into the port's types;
- ``simulate_legacy`` under the same three policies;
- SaturnStatic on instances of at most four jobs, once each package's
  MILP reports an optimal status (an optimal plan is unique up to ties
  that both packages break the same way);
- the LNS with a fixed seed and an iteration cap that binds before its
  wall deadline;
- serving fleets (data/traffic.py, serving/fleet.py) beside training,
  static and adaptive, on tests/test_fleet.py's mixed run.

The LNS and portfolio properties of tests/test_lns.py and
tests/test_portfolio.py are held on the port with ``deadline=None``:
their bodies run a 0.3 s or 1 s wall budget, past Hypothesis's default
200 ms deadline.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import _torch_port  # noqa: F401  (thread cap)
from _hypothesis_compat import given, settings, st
from repro.core import baselines as jb
from repro.core import chaos as jchaos
from repro.core import executor as jex
from repro.core import lns as jlns
from repro.core import solver as jsolver
from repro.core.job import ClusterSpec as JClusterSpec
from repro_torch.configs import get_config
from repro_torch.core import baselines as pb
from repro_torch.core import chaos as pchaos
from repro_torch.core import executor as pex
from repro_torch.core import lns as plns
from repro_torch.core import solver as psolver
from repro_torch.core.job import ClusterSpec, Job
from repro_torch.core.lns import lns_solve, validate_capacity
from repro_torch.core.portfolio import join_stragglers, solve_portfolio
from repro_torch.core.profiler import Profile
from repro_torch.core.solver import (OBJECTIVES, Choice, greedy_schedule,
                                     objective_value)
from repro_torch.models.config import ModelConfig

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "_bench_run", ROOT / "benchmarks" / "run.py")
BENCH = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(BENCH)

PKG = {"jax": (jb, jex, jchaos, JClusterSpec),
       "torch": (pb, pex, pchaos, ClusterSpec)}


def _port_cfg(cfg):
    assert cfg.moe is None
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


def _port_workload(jobs, profiles):
    """The JAX package's jobs and profiles as the port's types."""
    cfg = _port_cfg(jobs[0].cfg)
    pjobs = [Job(**{f.name: getattr(j, f.name)
                    for f in dataclasses.fields(j) if f.name != "cfg"},
                 cfg=cfg) for j in jobs]
    pprofiles = {k: Profile(**dataclasses.asdict(p))
                 for k, p in profiles.items()}
    return pjobs, pprofiles


def _both(workload):
    jobs, profiles = workload
    return {"jax": (jobs, profiles), "torch": _port_workload(jobs, profiles)}


def _outcome(res):
    return (res.policy, res.makespan_s,
            [dataclasses.astuple(g) for g in res.gantt],
            res.replans, res.restarts, res.failures)


def test_port_config_is_the_reference_config():
    jobs, _ = BENCH._synthetic_runtime_workload(n_jobs=2)
    assert dataclasses.asdict(_port_cfg(jobs[0].cfg)) == \
        dataclasses.asdict(get_config("xlstm-125m").reduced())


def _policy(mod, name):
    return {"CurrentPractice": mod.CurrentPractice,
            "Optimus": mod.Optimus,
            "OptimusDynamic": mod.OptimusDynamic}[name]()


def _trace(chaos_mod, seed):
    ev = chaos_mod.poisson_node_failures(
        8.0, 30000.0, seed=seed, n_gpus=4, recover_after_s=1200.0,
        max_rate_per_hour=8.0)
    return chaos_mod.ChaosTrace(ev, checkpoint_every_s=300.0)


@pytest.mark.parametrize("placement,chaos_seed", [("flat", None),
                                                  ("flat", 11),
                                                  ("node", None)])
@pytest.mark.parametrize("policy", ["CurrentPractice", "Optimus",
                                    "OptimusDynamic"])
def test_simulate_is_bit_identical(policy, placement, chaos_seed):
    work = _both(BENCH._chaos_workload() if chaos_seed is not None
                 else BENCH._synthetic_runtime_workload(n_jobs=8, seed=0))
    out = {}
    for name, (base, ex, chaos_mod, Cluster) in PKG.items():
        jobs, profiles = work[name]
        cluster = Cluster(nodes=2, gpus_per_node=8, restart_cost_s=30.0,
                          placement=placement)
        trace = _trace(chaos_mod, chaos_seed) if chaos_seed is not None \
            else None
        res = ex.simulate(jobs, _policy(base, policy), profiles, cluster,
                          introspect_every_s=600.0, noise_sigma=0.1,
                          noise_seed=3, chaos=trace)
        out[name] = _outcome(res)
    assert out["torch"] == out["jax"]
    assert len(out["torch"][2]) >= len(work["jax"][0])
    if chaos_seed is not None:
        assert out["torch"][5] > 0          # the trace did take devices


def test_node_placement_refuses_chaos_in_both():
    """Node-aware placement is not elastic: both packages refuse a
    failure trace on it, with the same message."""
    work = _both(BENCH._chaos_workload())
    msgs = {}
    for name, (base, ex, chaos_mod, Cluster) in PKG.items():
        jobs, profiles = work[name]
        with pytest.raises(ValueError, match="elastic") as e:
            ex.simulate(jobs, base.Optimus(), profiles,
                        Cluster(nodes=2, gpus_per_node=8, placement="node"),
                        chaos=_trace(chaos_mod, 11))
        msgs[name] = str(e.value)
    assert msgs["torch"] == msgs["jax"]


@pytest.mark.parametrize("policy", ["CurrentPractice", "Optimus",
                                    "OptimusDynamic"])
def test_simulate_legacy_is_bit_identical(policy):
    work = _both(BENCH._synthetic_runtime_workload(n_jobs=6, seed=2))
    out = {}
    for name, (base, ex, _, Cluster) in PKG.items():
        jobs, profiles = work[name]
        res = ex.simulate_legacy(
            jobs, _policy(base, policy), profiles,
            Cluster(nodes=1, gpus_per_node=8, restart_cost_s=10.0),
            introspect_every_s=300.0, noise_sigma=0.1, noise_seed=1)
        out[name] = _outcome(res)
    assert out["torch"] == out["jax"]


def test_chaos_traces_are_identical():
    for seed in (7, 11, 23):
        a = _trace(jchaos, seed)
        b = _trace(pchaos, seed)
        assert [dataclasses.astuple(e) for e in a] == \
            [dataclasses.astuple(e) for e in b]
    assert [dataclasses.astuple(e) for e in jchaos.spot_capacity_trace(
        20000.0, seed=3, n_gpus=2)] == [
        dataclasses.astuple(e) for e in pchaos.spot_capacity_trace(
            20000.0, seed=3, n_gpus=2)]


@pytest.mark.parametrize("adaptive", [False, True])
def test_serving_fleets_are_bit_identical(adaptive):
    """tests/test_fleet.py's mixed run (a bursty serving trace beside
    three training jobs on 8 GPUs), through data/traffic.py and
    serving/fleet.py in both packages: the same makespan, Gantt,
    restarts and per-window serving stats."""
    import repro.data.traffic as jtraffic
    import repro.serving.fleet as jfleet
    from repro.core.job import DeviceClass as JDeviceClass
    from repro.core.job import Job as JJob
    from repro.core.job import ServeJob as JServeJob
    from repro.core.profiler import Profile as JProfile
    import repro_torch.data.traffic as ptraffic
    import repro_torch.serving.fleet as pfleet
    from repro_torch.core.job import DeviceClass, ServeJob
    pkgs = {"jax": (jb, jex, JClusterSpec, JDeviceClass, JJob, JServeJob,
                    JProfile, jtraffic, jfleet),
            "torch": (pb, pex, ClusterSpec, DeviceClass, Job, ServeJob,
                      Profile, ptraffic, pfleet)}
    out = {}
    for name, (base, ex, Cluster, DC, J, SJ, Prof, traffic, fleet) in \
            pkgs.items():
        cfg = get_config("xlstm-125m").reduced()
        cluster = Cluster(device_classes=(DC("a100", nodes=1,
                                             gpus_per_node=8,
                                             hbm_per_gpu=40e9),))
        jobs = [J(f"t{i}", cfg, 8, 64, total_steps=800, seed=i)
                for i in range(3)]
        profiles = {(j.name, "ddp", "a100", g): Prof(
            j.name, "ddp", g, 0.4 / g ** 0.9, 1e9, True, "t",
            device_class="a100") for j in jobs for g in (1, 2, 4)}
        trace = traffic.bursty_trace(2.0, 600.0, seed=1, burst_rps=25.0,
                                     burst_every_s=300.0, burst_len_s=120.0)
        serve = SJ(name="svc", cfg=cfg, slo_p99_s=1.0, slots=4,
                   gpus_per_replica=1, trace=trace)
        profiles.update(fleet.serve_profiles([serve], cluster,
                                             base_step_s=0.004))
        if adaptive:
            fm = fleet.FleetManager([serve], cluster, window_s=60.0,
                                    horizon_s=600.0)
            policy = base.Optimus()
        else:
            fm = base.static_partition_fleets([serve], cluster,
                                              window_s=60.0,
                                              horizon_s=600.0)
            policy = base.CurrentPractice()
        res = ex.simulate(jobs, policy, profiles, cluster,
                          introspect_every_s=60.0, fleets=fm)
        out[name] = (_outcome(res), list(trace), res.stats["serving"])
    assert out["torch"] == out["jax"]
    assert out["torch"][2]["svc"]["requests"] > 0


@pytest.mark.parametrize("n_jobs,seed", [(3, 0), (4, 5)])
def test_saturn_static_matches_when_optimal(n_jobs, seed):
    work = _both(BENCH._solver_workload(n_jobs, total_gpus=4, seed=seed))
    out, status = {}, {}
    for name, (base, ex, _, Cluster) in PKG.items():
        jobs, profiles = work[name]
        res = ex.simulate(jobs, base.SaturnStatic(time_limit_s=20),
                          profiles,
                          Cluster(nodes=1, gpus_per_node=4,
                                  restart_cost_s=10.0),
                          noise_sigma=0.0)
        status[name] = [s["status"] for s in res.stats["solver"]]
        out[name] = _outcome(res)
    for name, st_ in status.items():
        assert st_ and all("Optimal" in s for s in st_), (name, st_)
    assert out["torch"] == out["jax"]


def _lns_workload(n_jobs, seed, solver_mod, classes=(None,),
                  deadlines=False, tenants=1):
    """tests/test_lns.py's workload, built with one package's types."""
    cfg = get_config("xlstm-125m").reduced()
    rng = np.random.RandomState(seed)
    budgets = {dc: 16 for dc in classes}
    jobs, cm = [], {}
    for i in range(n_jobs):
        kw = {}
        if deadlines and rng.rand() < 0.7:
            kw["deadline_s"] = float(rng.uniform(50, 400))
        if tenants > 1:
            kw["tenant"] = f"t{rng.randint(tenants)}"
        kw["weight"] = float(rng.uniform(0.5, 3.0))
        j = Job(f"j{i}", cfg, batch_size=8, seq_len=64,
                total_steps=int(rng.randint(50, 300)), **kw)
        jobs.append(j)
        base = rng.uniform(20.0, 200.0)
        eff = rng.uniform(0.5, 0.95)
        cm[j.name] = [solver_mod.Choice(
            "fsdp", g, base / (g ** eff) / (1.0 if dc in (None, "a100")
                                            else 0.5), device_class=dc)
            for dc in classes for g in (1, 2, 4, 8)]
    return jobs, cm, budgets


def _plan(sol):
    return sorted((a.job, a.technique, a.n_gpus, a.device_class, a.start_s,
                   a.runtime_s) for a in sol.assignments)


@pytest.mark.parametrize("objective", ["makespan", "weighted_completion"])
def test_lns_fixed_seed_is_bit_identical(objective):
    """An iteration cap that binds before the wall deadline makes the
    LNS deterministic (tests/test_lns.py), so the packages agree."""
    out = {}
    for name, (mod, solver_mod) in {"jax": (jlns, jsolver),
                                    "torch": (plns, psolver)}.items():
        jobs, cm, budgets = _lns_workload(10, 42, solver_mod,
                                          deadlines=True, tenants=2)
        sol = mod.lns_solve(jobs, cm, budgets, deadline_s=60.0,
                            max_iters=60, seed=7, objective=objective)
        assert mod.validate_capacity(sol.assignments, budgets)
        out[name] = (_plan(sol), sol.telemetry["iters"])
    assert out["torch"] == out["jax"]


# ----------------------------------------------- properties on the port

@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000),
       n_jobs=st.integers(2, 14),
       objective=st.sampled_from(OBJECTIVES),
       hetero=st.booleans())
def test_lns_conserves_capacity_and_beats_seed(seed, n_jobs, objective,
                                               hetero):
    classes = ("a100", "v100") if hetero else (None,)
    jobs, cm, budgets = _lns_workload(n_jobs, seed, psolver,
                                      classes=classes, deadlines=True,
                                      tenants=3)
    sol = lns_solve(jobs, cm, budgets, objective=objective,
                    deadline_s=0.3, seed=seed)
    assert {a.job for a in sol.assignments} == {j.name for j in jobs}
    assert validate_capacity(sol.assignments, budgets)
    gv = objective_value(greedy_schedule(jobs, cm, budgets,
                                         objective=objective).assignments,
                         jobs, objective)
    assert objective_value(sol.assignments, jobs, objective) <= gv + 1e-6


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000), n_jobs=st.integers(2, 10))
def test_lns_respects_reserved_triples(seed, n_jobs):
    jobs, cm, budgets = _lns_workload(n_jobs, seed, psolver)
    reserved = [(None, 6, 80.0), (None, 4, float("inf"))]
    sol = lns_solve(jobs, cm, budgets, reserved=reserved,
                    deadline_s=0.3, seed=seed)
    assert {a.job for a in sol.assignments} == {j.name for j in jobs}
    assert validate_capacity(sol.assignments, budgets, reserved=reserved)
    assert all(a.n_gpus <= 12 for a in sol.assignments)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10_000), n_jobs=st.integers(3, 12))
def test_portfolio_feasible_and_never_worse_than_greedy(seed, n_jobs):
    cfg = get_config("xlstm-125m").reduced()
    rng = np.random.RandomState(seed)
    jobs, cm = [], {}
    for i in range(n_jobs):
        j = Job(f"j{i}", cfg, batch_size=8, seq_len=64,
                total_steps=int(rng.randint(50, 300)))
        jobs.append(j)
        base, eff = rng.uniform(20.0, 200.0), rng.uniform(0.5, 0.95)
        cm[j.name] = [Choice("fsdp", g, base / g ** eff)
                      for g in (1, 2, 4, 8)]
    budgets = {None: 16}
    sol = solve_portfolio(jobs, cm, budgets, wall_budget_s=1.0,
                          gap_target=0.05, seed=seed)
    join_stragglers()
    assert {a.job for a in sol.assignments} == {j.name for j in jobs}
    assert validate_capacity(sol.assignments, budgets)
    gv = greedy_schedule(jobs, cm, budgets).makespan_s
    assert objective_value(sol.assignments, jobs, "makespan") <= gv + 1e-6
    assert sol.solver.startswith("portfolio[")
